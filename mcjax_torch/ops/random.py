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

``TorchRandoms`` draws these on the device from explicit
``torch.Generator``s; nothing reads PyTorch's global generator. The volume
moves have a generator of their own, as the JAX package keys them apart
(``fold_in(key, -(sweep + 1))``), so an NPT run's particle draws are an
NVT run's, draw for draw. Tests plug in a provider that evaluates the JAX
package's own Threefry key tree, which makes hard-core trajectories
bitwise comparable with it.
"""

from __future__ import annotations

from typing import Protocol

import torch

from mcjax_torch.core.config import SimConfig


class RandomProvider(Protocol):
    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]: ...

    def volume(self, cfg: SimConfig, sweep: int, dlnv_max: float
               ) -> tuple[torch.Tensor, torch.Tensor]: ...


# Mixed into the run's seed to seed the volume-move generator.
VOLUME_STREAM = 0x9E3779B97F4A7C15


class TorchRandoms:
    """Draws the schedule and sub-step tensors of a run from one
    ``torch.Generator`` and the NPT volume moves from a second one.

    The numbers are drawn on the generator's device in call order; the
    ``sweep`` and ``i`` arguments only fix shapes. The volume generator,
    on the same device, is seeded from the first one's seed (xor
    ``VOLUME_STREAM``) at the first volume draw. Nothing here waits for the
    device.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device
        self.volume_generator: torch.Generator | None = None

    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g, dev = self.generator, self.device
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
        g, dev = self.generator, self.device
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
            self.volume_generator = torch.Generator(self.device).manual_seed(
                self.generator.initial_seed() ^ VOLUME_STREAM)
        g, dev = self.volume_generator, self.device
        dlnv = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            -dlnv_max, dlnv_max, generator=g)
        u = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            1e-38, 1.0, generator=g)
        return dlnv, u
