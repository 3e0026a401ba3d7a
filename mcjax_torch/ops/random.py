"""The random-number seam between a sweep and where its numbers come from.

A provider hands a sweep its schedule and each color sub-step its random
tensors, with the shapes and meaning of the JAX package's draws
(``mcjax.ops.sweep.mc_sweep`` and ``substep_randoms``):

* ``schedule(cfg, sweep)`` -> ``(perm, axis, d)``: the color permutation
  (int32 [n_colors]), the shift axis (int32 0-d) and the shift distance
  (float32 0-d, uniform in [-w/2, w/2)), all on the provider's device;
* ``substep(cfg, sweep, i, need_acc)`` -> ``(pick_u, disp, acc_u)`` for the
  i-th sub-step of the sweep (position i in the permutation):
  pick_u [n_moves, *bs] uniform in [0, 1), disp [n_moves, dim, *bs]
  (uniform in [-step, step) or gaussian × step), and acc_u [n_moves, *bs]
  uniform in [0, 1), or None when ``need_acc`` is False (hard-core models
  never read it);
* ``volume(cfg, sweep, dlnv_max)`` -> ``(dlnv, u)``: the NPT volume move
  made after the particle moves of a sweep (``sweep`` counts the sweeps
  done, that one included): dlnv uniform in [-dlnv_max, dlnv_max) and the
  acceptance uniform u in [1e-38, 1), both float32 0-d, the draws of
  ``mcjax.ops.npt.npt_sweep``.

Every draw is keyed, as the JAX package keys its draws by (key, sweep,
sub-step) (``fold_in(key, sweep)``, ``mcjax/ops/sweep.py:260-263``): it
depends on the run's seed and on where it is taken, never on how many
draws came before, so a run resumed at sweep s continues the stream of
an unbroken one.

``TorchRandoms`` draws with PyTorch's generators on the device. Before
each draw it re-seeds its generator from (seed, sweep, sub-step i) or
(seed, sweep, stream), a host-only ``manual_seed``; the volume moves have
a generator of their own, as the JAX package keys them apart
(``fold_in(key, -(sweep + 1))``), so an NPT run's particle draws are an
NVT run's, draw for draw.

``PhiloxRandoms`` is the counter-based stream that the sub-step kernels
generate in registers (``csrc/philox.cuh``, mcjax's in-kernel PRNG form,
``mcjax/ops/pallas_sweep.py:226-350``). Each word is one of the four of
Philox4x32-10 (Random123) at

    key     = (seed mod 2^32, (seed >> 32) mod 2^32)
    counter = (c0, c1, sweep mod 2^32, (tag << 16) | i)

with tag MOVES, SCHEDULE or VOLUME. For the moves of sub-step i (color
c = perm[i]) c1 is the global cell id c * prod(block_shape) + the cell's
flat (row-major) block index, and c0 = m * calls + k is call k of move m;
a move's words are, in order, pick, acc (energetic models only), then
the displacement components, calls = ceil(words / 4). A uniform component
is one word, step * (2u - 1); a gaussian component the Irwin-Hall sum of
``ih_k`` 16-bit halves, the high half of each word first, ceil(ih_k / 2)
words. A uniform u of a word w is (w >> 8) * 2^-24 (``_uniform_01``). The
2D hard-disk move (pick, dx, dy) is one call; a 3D gaussian LJ move at
``ih_k`` 8 is 14 words, four calls. The schedule (c1 = 0, i = 0) takes
words 0 .. n_colors - 2 for a Fisher-Yates shuffle with a multiply-shift
bound, then one for the axis, one for d; the volume move (c1 = 0, i = 0)
two, for dlnv and u.

``substep`` materializes a sub-step's words with the plain PyTorch
``philox4x32`` on the provider's device: the plain version of the
kernels' in-kernel draws, float for float. ``schedule`` and ``volume``
evaluate their few words in Python integers on the host and hand the
device one pinned, non-blocking copy: a sweep needs no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Protocol

import numpy as np
import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device


class RandomProvider(Protocol):
    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]: ...

    def volume(self, cfg: SimConfig, sweep: int, dlnv_max: float
               ) -> tuple[torch.Tensor, torch.Tensor]: ...


# Philox4x32 (Random123): round multipliers and Weyl key increments.
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF

# Stream tags: the high half of counter word 3.
TAG_MOVES, TAG_SCHEDULE, TAG_VOLUME = 1, 2, 3
# TorchRandoms' seed of the schedule and volume draws: the sub-step slot
# i of the key (sub-steps use 0 .. n_colors - 1).
SCHEDULE_STREAM, VOLUME_STREAM = 0xFFFE, 0xFFFF


def philox4x32_int(ctr: tuple[int, int, int, int], key: tuple[int, int],
                   rounds: int = 10) -> tuple[int, int, int, int]:
    """Philox4x32-``rounds`` of one counter in Python integers."""
    c0, c1, c2, c3 = (v & MASK32 for v in ctr)
    k0, k1 = (v & MASK32 for v in key)
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        p0, p1 = PHILOX_M0 * c0, PHILOX_M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK32)
    return c0, c1, c2, c3


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * m for int64 words a < 2^32 and a
    constant m < 2^32. The factor a is split into 16-bit halves so that no
    partial product leaves the signed int64 range."""
    t_lo = (a & 0xFFFF) * m                       # < 2^48
    t_hi = (a >> 16) * m                          # < 2^48
    mid = t_lo + ((t_hi & 0xFFFF) << 16)          # < 2^49
    return (t_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32(ctr: torch.Tensor, key: tuple[int, int], rounds: int = 10
               ) -> torch.Tensor:
    """Philox4x32-``rounds`` (Random123's philox4x32_R) of every counter,
    the plain version of ``csrc/philox.cuh``: ``ctr`` is an int64 tensor
    [4, ...] of 32-bit words, ``key`` two integers; returns the int64
    [4, ...] output words, each in [0, 2^32)."""
    if ctr.dtype != torch.int64 or ctr.shape[0] != 4:
        raise ValueError(f"ctr: want int64 [4, ...], got {ctr.dtype} "
                         f"{tuple(ctr.shape)}")
    c0, c1, c2, c3 = (w & MASK32 for w in ctr.unbind(0))
    k0, k1 = (v & MASK32 for v in key)
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3))


def uniform_01(w: torch.Tensor) -> torch.Tensor:
    """Words -> float32 uniforms in [0, 1): the top 24 bits times 2^-24,
    exact (``mcjax.ops.pallas_sweep._uniform_01``)."""
    return (w >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_step(w: torch.Tensor, step: float) -> torch.Tensor:
    """Uniform proposals f32(step) * (2u - 1) in [-step, step); 2u - 1 is
    exact, so one rounding."""
    return torch.tensor(step, dtype=torch.float32) * (2.0 * uniform_01(w)
                                                      - 1.0)


def irwin_hall_constants(step: float, ih_k: int) -> tuple[float, float]:
    """(c1, c0), float32 values: a gaussian component is fma(c1, S, -c0)
    for the sum S of ``ih_k`` 16-bit halves, i.e. sum((h + 0.5) 2^-16) -
    K/2 rescaled to variance step^2, with mcjax's float32 constants
    (``mcjax/ops/pallas_sweep.py:318-346``)."""
    if not (isinstance(ih_k, int) and 2 <= ih_k <= 64):
        raise ValueError(f"ih_k must be an int in [2, 64], got {ih_k!r}")
    scale = np.float32(step * math.sqrt(12.0 / ih_k))
    c1 = scale * np.float32(1.0 / 65536.0)
    c0 = scale * np.float32(ih_k * (0.5 - 1.0 / 131072.0))
    return float(c1), float(c0)


def irwin_hall(halves_sum: torch.Tensor, step: float, ih_k: int
               ) -> torch.Tensor:
    """Gaussian proposals from the integer sums of ``ih_k`` 16-bit halves:
    fma(c1, S, -c0) rounded once to float32. The float64 evaluation is
    exact (c1 S has at most 46 significant bits and c0 is a float32 on
    the same grid, so their difference fits 53 bits), so this is the
    kernels' __fmaf_rn bit for bit."""
    c1, c0 = irwin_hall_constants(step, ih_k)
    return (c1 * halves_sum.to(torch.float64) - c0).to(torch.float32)


def move_layout(cfg: SimConfig, need_acc: bool, ih_k: int
                ) -> tuple[int, int]:
    """(words a component, Philox calls a move) of PhiloxRandoms' moves."""
    per = 1 if cfg.proposal == "uniform" else (ih_k + 1) // 2
    words = 1 + int(need_acc) + cfg.dim * per
    return per, -(-words // 4)


def seed_words(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32 bits."""
    return seed & MASK32, (seed >> 32) & MASK32


class PhiloxKey(NamedTuple):
    """What the sub-step kernels need to generate a sweep's draws: the
    run's seed, the sweep and the Irwin-Hall order of gaussian proposals
    (all passed by value)."""
    seed: int
    sweep: int
    ih_k: int


def _to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``: on CUDA one non-blocking copy
    from pinned memory (PyTorch's pinned-memory cache keeps the block
    until the copy is done), so the host does not wait."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PhiloxRandoms:
    """The keyed Philox4x32-10 stream of the module docstring, on
    ``device``, with gaussian proposals of Irwin-Hall order ``ih_k``.

    ``kernel_key(sweep)`` hands the sub-step kernels the key of a sweep,
    so that they generate its draws in registers; ``substep`` is the
    plain version of those draws.
    """

    def __init__(self, seed: int, device: str | torch.device | None = None,
                 ih_k: int = 12):
        if not (isinstance(ih_k, int) and 2 <= ih_k <= 64):
            raise ValueError(f"ih_k must be an int in [2, 64], got {ih_k!r}")
        self.seed = int(seed)
        self.key = seed_words(self.seed)
        self.device = resolve_device(device)
        self.ih_k = ih_k
        self._sched: tuple[tuple, tuple] | None = None

    def kernel_key(self, sweep: int) -> PhiloxKey:
        return PhiloxKey(self.seed, sweep, self.ih_k)

    def _words(self, tag: int, sweep: int, n: int) -> list[int]:
        out: list[int] = []
        for c in range(-(-n // 4)):
            out += philox4x32_int((c, 0, sweep, tag << 16), self.key)
        return out[:n]

    def host_schedule(self, cfg: SimConfig, sweep: int
                      ) -> tuple[list[int], int, np.float32]:
        """(perm, axis, d) of a sweep on the host."""
        at = (cfg.n_colors, cfg.dim, cfg.cell_width, sweep)
        if self._sched is None or self._sched[0] != at:
            n = cfg.n_colors
            w = self._words(TAG_SCHEDULE, sweep, n + 1)
            perm = list(range(n))
            for k in range(n - 1, 0, -1):           # Fisher-Yates
                j = (w[n - 1 - k] * (k + 1)) >> 32
                perm[k], perm[j] = perm[j], perm[k]
            axis = (w[n - 1] * cfg.dim) >> 32
            u = np.float32((w[n] >> 8) * (1.0 / (1 << 24)))
            half_w = np.float32(cfg.cell_width / 2.0)
            d = half_w * (np.float32(2.0) * u - np.float32(1.0))
            self._sched = (at, (perm, axis, d))
        return self._sched[1]

    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        perm, axis, d = self.host_schedule(cfg, sweep)
        host = np.array([*perm, axis, 0], dtype=np.int32)
        host[-1:] = np.array([d], dtype=np.float32).view(np.int32)
        dev = _to_device(host, self.device)
        n = cfg.n_colors
        return dev[:n], dev[n], dev[n + 1:].view(torch.float32).reshape(())

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        return self.move_draws(cfg, sweep, i,
                               self.host_schedule(cfg, sweep)[0][i], need_acc)

    def move_draws(self, cfg: SimConfig, sweep: int, i: int, color: int,
                   need_acc: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """``substep``'s draws with the cells keyed by ``color``."""
        bs, n_m, dim = cfg.block_shape, cfg.n_moves, cfg.dim
        cells = math.prod(bs)
        per, calls = move_layout(cfg, need_acc, self.ih_k)
        dev = self.device
        i64 = torch.int64
        c0 = torch.arange(n_m * calls, dtype=i64, device=dev).reshape(
            n_m * calls, 1)
        c1 = color * cells + torch.arange(cells, dtype=i64, device=dev)
        ctr = torch.stack(torch.broadcast_tensors(
            c0, c1[None], torch.tensor(sweep & MASK32, device=dev),
            torch.tensor((TAG_MOVES << 16) | i, device=dev)))
        w = philox4x32(ctr, self.key)                  # [4, n_m*calls, P]
        # word k of a move: word k % 4 of its call k // 4
        w = w.reshape(4, n_m, calls, cells).permute(1, 2, 0, 3).reshape(
            n_m, 4 * calls, cells)
        pick_u = uniform_01(w[:, 0]).reshape(n_m, *bs)
        acc_u = uniform_01(w[:, 1]).reshape(n_m, *bs) if need_acc else None
        first = 1 + int(need_acc)
        comps = w[:, first:first + dim * per].reshape(n_m, dim, per, cells)
        if cfg.proposal == "uniform":
            disp = uniform_step(comps[:, :, 0], cfg.step_size)
        else:
            halves = torch.stack((comps >> 16, comps & 0xFFFF), dim=3)
            s = halves.reshape(n_m, dim, 2 * per, cells)[:, :, :self.ih_k]
            disp = irwin_hall(s.sum(dim=2), cfg.step_size, self.ih_k)
        return pick_u, disp.reshape(n_m, dim, *bs).contiguous(), acc_u

    def volume(self, cfg: SimConfig, sweep: int, dlnv_max: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
        w = self._words(TAG_VOLUME, sweep, 2)
        u0, u1 = (np.float32((v >> 8) * (1.0 / (1 << 24))) for v in w)
        dlnv = np.float32(dlnv_max) * (np.float32(2.0) * u0 - np.float32(1.0))
        u = max(u1, np.float32(1e-38))
        dev = _to_device(np.array([dlnv, u], dtype=np.float32), self.device)
        return dev[0], dev[1]


class TorchRandoms:
    """Draws the schedule and sub-step tensors of a run from one
    ``torch.Generator`` and the NPT volume moves from a second one.

    Each draw re-seeds its generator first (a host-only ``manual_seed``)
    from the first generator's initial seed, the sweep and the sub-step
    i (or the schedule's or the volume moves' stream), through one
    Philox call, so the draws are keyed as the module docstring says. The
    volume generator, on the same device, is made at the first volume
    draw. Nothing here waits for the device.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device
        self.seed = generator.initial_seed()
        self.volume_generator: torch.Generator | None = None

    def _reseed(self, g: torch.Generator, sweep: int, slot: int
                ) -> torch.Generator:
        w = philox4x32_int((slot, 0, sweep, 0), seed_words(self.seed))
        return g.manual_seed(w[0] | (w[1] << 32))

    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g, dev = self._reseed(self.generator, sweep, SCHEDULE_STREAM), \
            self.device
        perm = torch.randperm(cfg.n_colors, generator=g, device=dev,
                              dtype=torch.int32)
        axis = torch.randint(0, cfg.dim, (), generator=g, device=dev,
                             dtype=torch.int32)
        half_w = cfg.cell_width / 2.0
        d = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            -half_w, half_w, generator=g)
        return perm, axis, d

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        g, dev = self._reseed(self.generator, sweep, i), self.device
        n_m, dim, bs = cfg.n_moves, cfg.dim, cfg.block_shape
        pick_u = torch.rand((n_m, *bs), generator=g, device=dev)
        disp = torch.empty((n_m, dim, *bs), dtype=torch.float32, device=dev)
        if cfg.proposal == "gaussian":
            disp.normal_(0.0, cfg.step_size, generator=g)
        else:
            disp.uniform_(-cfg.step_size, cfg.step_size, generator=g)
        acc_u = (torch.rand((n_m, *bs), generator=g, device=dev)
                 if need_acc else None)
        return pick_u, disp, acc_u

    def volume(self, cfg: SimConfig, sweep: int, dlnv_max: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.volume_generator is None:
            self.volume_generator = torch.Generator(self.device)
        g, dev = self._reseed(self.volume_generator, sweep, VOLUME_STREAM), \
            self.device
        dlnv = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            -dlnv_max, dlnv_max, generator=g)
        u = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            1e-38, 1.0, generator=g)
        return dlnv, u
