"""Color sub-step: plain PyTorch version and the wrappers of its CUDA kernels.

Three kernels compute color sub-steps on the card; ``substeps`` picks one
by (dim, model) and raises for any other configuration:

* ``csrc/substep.cu``, 2D hard disks: one cooperative launch runs a range
  of sub-steps of a sweep (all four in ``mc_sweep``), with a grid barrier
  between them; one thread owns one cell, with its culled frozen slots in
  shared memory. It stands for ``mcjax/ops/pallas_ring.py::
  ring_sweep_onecall`` and the 2D form of ``ring_color_substep`` (body
  ``mcjax/ops/pallas_sweep.py::_make_kernel``), host-random form.
* ``csrc/substep_lj.cu``, 3D Lennard-Jones: one warp owns one cell, with the
  frozen-neighbor energy cache; the frozen slots that can reach the cell
  are staged in shared memory (``cull_constants``) and only pairs within
  the cutoff get the full term. It stands for
  ``mcjax/ops/pallas_sweep.py::_fused_core``, the single-species energetic
  form of ``pallas_color_substep`` and the 3D energetic form of
  ``ring_color_substep``, host-random form.
* ``csrc/substep_mix.cu``, 3D binary Lennard-Jones mixtures with a
  species-independent cutoff ratio (Kob-Andersen): the LJ kernel's design
  with two own slots a lane (nmax <= 64), the species staged beside the
  coordinates and the species plane read-only.
  It stands for the binary-mixture form of ``_fused_core`` (frozen cache)
  and of ``pallas_color_substep``, host-random form.

``color_substep`` below is the plain version of the first two, a twin of
``mcjax.ops.sweep.color_substep`` (hard-core and energetic branches);
``mcjax_torch.ops.mixture.color_substep_mixture`` is the third's. On a CPU
tensor ``substeps`` runs the plain version once per sub-step; on a CUDA
tensor it launches the 2D kernel once for the range, or an energetic
kernel once per sub-step.

Each kernel has an NPT form, a compile-time variant (mcjax's static
``use_scale``): given the box scale s of the stored-frame convention
(``mcjax_torch.ops.npt``), every pair's squared distance is multiplied by
s^2 = f32(s * s), read from device memory, before its cutoff, overlap or
energy, in the moves and in the frozen-cache build, as the TPU kernels
multiply by their SMEM s^2 (``mcjax/ops/pallas_sweep.py:435-446,
:610-636``). Without a scale the NVT kernels run, unchanged.

Each kernel also has a field form, another compile-time variant (mcjax's
static ``field`` of ``_make_kernel``, ``mcjax/ops/pallas_sweep.py:140-145``):
an external one-body field (``mcjax_torch.models.fields``, flattened into
``field_params``) is evaluated in the kernel at physical x = wrap(stored +
origin), the origin read from device memory, so it moves on the device
with no host sync. A move into the forbidden region is rejected before any
pair work; a field with energy adds its term to dE once a move (and makes
the 2D hard-core kernel energetic). The field form never combines with the
NPT form: the JAX package has no NPT run under a field. The 2D kernel's
field form is built from ``csrc/substep_field.cu`` into a library of its
own (``LIB_FIELD``), beside ``csrc/substep.cu``'s NVT and NPT forms.

Each kernel has a Philox form too (mcjax's ``in_kernel_rng``,
``mcjax/ops/pallas_sweep.py:226-350``): ``substeps`` given a
``PhiloxKey`` instead of materialized draws launches it, and the kernel
generates every move's draws in registers from the key (``csrc/
philox.cuh``, the stream of ``mcjax_torch.ops.random.PhiloxRandoms``),
reading no random input. The 2D Philox form is built from
``csrc/substep_philox.cu`` into ``LIB_PHILOX``; the energetic kernels'
sit in their own libraries. On the CPU a key is materialized by
``PhiloxRandoms`` and the plain sub-step runs: that is the Philox forms'
plain version. The Philox form takes neither a field (later work,
ROADMAP B3) nor an NPT scale (the JAX package has no such form); on CUDA
``substeps`` raises for those rather than materialize the draws.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from mcjax_torch._build import CudaLibrary
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import check_tensors
from mcjax_torch.core.geometry import wrap_into_box
from mcjax_torch.models import fields
from mcjax_torch.models.mixtures import LJMixture, _blend
from mcjax_torch.models.potentials import (HardSphere, LennardJones, Potential,
                                           fma_f32, pair_interaction)
from mcjax_torch.ops import cells
from mcjax_torch.ops.random import (MASK32, PhiloxKey, PhiloxRandoms,
                                    irwin_hall_constants, move_layout,
                                    philox4x32, seed_words)

# Largest cell capacity each kernel is instantiated for: the disk kernel
# stages a cell's own slots in a thread's shared memory, the LJ kernel one
# slot per lane, the mixture kernel two.
KERNEL_NMAX = 16
KERNEL_NMAX_LJ = 32
KERNEL_NMAX_MIX = 64

_ARGS_2D = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float]
_ARGS_LJ = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float]
_ARGS_MIX = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
_P, _S = ctypes.c_void_p, ctypes.c_void_p   # a pointer, the stream

LIB = CudaLibrary("substep", {
    "mcjax_substep_2d": [*_ARGS_2D, _P, _S],
    "mcjax_substep_2d_shape": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p],
})

# The 2D kernel's field form: a library of its own (csrc/substep_field.cu,
# the kernel of csrc/substep_2d.cuh), so that nvcc builds it beside LIB.
LIB_FIELD = CudaLibrary("substep_field", {
    "mcjax_substep_2d_field": [*_ARGS_2D, _P, _P, _P, _P, ctypes.c_float,
                               _S],
    "mcjax_substep_2d_field_shape": [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p],
})

# The 2D kernel's Philox form (csrc/substep_philox.cu), with the stream's
# words for given counters (mcjax_philox_words).
LIB_PHILOX = CudaLibrary("substep_philox", {
    "mcjax_substep_2d_philox": [*_ARGS_2D[:3], ctypes.c_int, ctypes.c_int,
                                *_ARGS_2D[7:], _P, _S],
    "mcjax_substep_2d_philox_shape": [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p],
    "mcjax_philox_words": [_P, ctypes.c_uint32, ctypes.c_uint32,
                           ctypes.c_longlong, _P, _S],
})

# The energetic kernels' Philox forms: their arguments without the three
# draw pointers, then the stream (PhiloxArgs).
_ARGS_LJ_PHILOX = [*_ARGS_LJ[:4], *_ARGS_LJ[7:]]
_ARGS_MIX_PHILOX = [*_ARGS_MIX[:4], *_ARGS_MIX[7:]]

LIB_LJ = CudaLibrary("substep_lj", {
    "mcjax_substep_lj3d": [*_ARGS_LJ, _P, _S],
    "mcjax_substep_lj3d_field": [*_ARGS_LJ, _P, _P, _S],
    "mcjax_substep_lj3d_philox": [*_ARGS_LJ_PHILOX, _P, _S],
    "mcjax_substep_lj3d_shape": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})

LIB_MIX = CudaLibrary("substep_mix", {
    "mcjax_substep_mix3d": [*_ARGS_MIX, _P, _S],
    "mcjax_substep_mix3d_field": [*_ARGS_MIX, _P, _P, _S],
    "mcjax_substep_mix3d_philox": [*_ARGS_MIX_PHILOX, _P, _S],
    "mcjax_substep_mix3d_shape": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})


class PhiloxArgs(ctypes.Structure):
    """csrc/philox.cuh ``mcjax_philox::Args``: a Philox form's stream."""
    _fields_ = [("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32),
                ("sweep", ctypes.c_uint32), ("ih_k", ctypes.c_int),
                ("step", ctypes.c_float), ("c1", ctypes.c_float),
                ("c0", ctypes.c_float), ("calls", ctypes.c_int)]


def philox_args(cfg: SimConfig, key: PhiloxKey, need_acc: bool
                ) -> PhiloxArgs:
    """The Philox form's ``PhiloxArgs`` for the sweep of ``key``: the seed
    words, the sweep, the proposal's constants (ih_k 0 for uniform
    proposals) and the calls a move, as ``PhiloxRandoms`` lays them out."""
    k0, k1 = seed_words(key.seed)
    _, calls = move_layout(cfg, need_acc, key.ih_k)
    if cfg.proposal == "uniform":
        return PhiloxArgs(k0, k1, key.sweep & MASK32, 0, cfg.step_size, 0.0,
                          0.0, calls)
    c1, c0 = irwin_hall_constants(cfg.step_size, key.ih_k)
    return PhiloxArgs(k0, k1, key.sweep & MASK32, key.ih_k, 0.0, c1, c0,
                      calls)


def philox_words(ctr: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of every counter: ``ctr`` int64 [4, n] of 32-bit
    words, the output likewise. On a CUDA tensor one launch of
    ``csrc/philox.cuh``'s generator (``mcjax_philox_words``); on the CPU
    the plain version, ``random.philox4x32``."""
    if ctr.dtype != torch.int64 or ctr.dim() != 2 or ctr.shape[0] != 4:
        raise ValueError(f"ctr: want int64 [4, n], got {ctr.dtype} "
                         f"{tuple(ctr.shape)}")
    if ctr.device.type == "cpu":
        return philox4x32(ctr, key)
    if ctr.device.type != "cuda":
        raise ValueError(f"no Philox generator for device {ctr.device}")
    c32 = (ctr & MASK32).to(torch.int32).contiguous()
    out = torch.empty_like(c32)
    k0, k1 = (v & MASK32 for v in key)
    LIB_PHILOX.launch("mcjax_philox_words", c32.data_ptr(), k0, k1,
                      ctr.shape[1], out.data_ptr(),
                      torch.cuda.current_stream(ctr.device).cuda_stream)
    return out.to(torch.int64) & MASK32

# Exact culling of frozen slots in the sub-step kernels. A frozen slot is
# staged only if its box distance to the own cell, the cell grown by
# ``cull_constants``'s pad on every side, is within the largest cutoff
# (the diameter for hard disks) grown by CULL_REL. The pad covers own
# slots that sit outside their cell after a grid shift (``validate_state``
# allows 1e-5 + 4 float32 ulps of L/2; the pad is CULL_PAD_ABS +
# CULL_PAD_ULPS ulps). CULL_REL covers the float32 rounding of the squared
# distance, the box distance and the mixture's cutoff test (a few ulps,
# against 1e-4). So a dropped slot is beyond every cutoff from every point
# a mover can hold, and would have added exactly 0 (or, for hard disks,
# never overlapped). The mixture kernel's candidate test grows each pair's
# cutoff by the same CULL_REL; the LJ kernel's is its exact r2 <= r_cut^2.
#
# Under an NPT box scale s a slot interacts when f32(s^2 * r~^2) is within
# the cutoff, so the kernels keep a slot whose squared box distance is at
# most f32(reach2 / s^2), divided once in the kernel from the s^2 it reads.
# The two extra roundings (of s^2 * r~^2 and of the division) add two
# ulps to the few CULL_REL covers, and CULL_REL is still some 400 times
# wider. The one-ring contract s w >= r_cut keeps the reach (1 + CULL_REL)
# r_cut / s within the ring of neighbor cells but for the same margin, and
# a slot outside the ring is never a candidate.
CULL_REL = 1e-4
CULL_PAD_ABS = 1e-5
CULL_PAD_ULPS = 64


def cull_constants(cfg: SimConfig, r_cut: float) -> tuple[float, float]:
    """(pad, reach2) of the frozen-slot culling for largest cutoff (or
    hard-core diameter) ``r_cut``: the own cell grows by ``pad`` on every
    side, and a slot is kept when its squared box distance is at most
    ``reach2``."""
    ulp = float(np.spacing(np.float32(cfg.box_length / 2.0)))
    pad = CULL_PAD_ABS + CULL_PAD_ULPS * ulp
    return pad, (r_cut * (1.0 + CULL_REL)) ** 2


def keep_frozen(cfg: SimConfig, r_cut: float, lower: torch.Tensor,
                slots: torch.Tensor, scale: float | None = None
                ) -> torch.Tensor:
    """The kernels' culling test in float32, for tests: True where a
    frozen slot at ``slots`` [..., dim] (unwrapped into the own cell's
    frame) is staged for the own cell whose lower corner is ``lower``
    [dim] (float32, as ``cell_lower_bounds`` gives it); under a box scale
    ``scale`` with the reach divided by s^2, as the NPT kernels divide
    it."""
    pad, reach2 = cull_constants(cfg, r_cut)
    f32 = torch.float32
    pad_t = torch.tensor(pad, dtype=f32)
    lo = lower - pad_t
    up = (lower + torch.tensor(cfg.cell_width, dtype=f32)) + pad_t
    d = torch.clamp(torch.maximum(lo - slots, slots - up), min=0.0)
    reach2_t = torch.tensor(reach2, dtype=f32)
    if scale is not None:
        reach2_t = reach2_t / scale_squared(scale, f32, reach2_t.device)
    return squared_norm(d, -1) <= reach2_t


MAX_FIELD_TERMS = 4    # csrc/field.cuh kMaxTerms


class FieldTerm(ctypes.Structure):
    """csrc/field.cuh ``mcjax_field::Term``."""
    _fields_ = [("kind", ctypes.c_int), ("axis", ctypes.c_int),
                ("species", ctypes.c_int), ("unit", ctypes.c_int),
                ("k", ctypes.c_float * 3), ("c", ctypes.c_float * 3),
                ("g", ctypes.c_float), ("coupling", ctypes.c_float * 2),
                ("lo", ctypes.c_float * 2), ("hi", ctypes.c_float * 2)]


class FieldParams(ctypes.Structure):
    """csrc/field.cuh ``mcjax_field::Params``: the field form's field."""
    _fields_ = [("n", ctypes.c_int), ("energetic", ctypes.c_int),
                ("axes", ctypes.c_int), ("t", FieldTerm * MAX_FIELD_TERMS)]


def _f32(v) -> float:
    return float(torch.as_tensor(v, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def field_params(field, dim: int, resolved: bool) -> FieldParams:
    """The field form's ``FieldParams`` for ``field`` in a ``dim``-D model,
    species-resolved (the mixture kernel: species 0 and 1) if
    ``resolved``. Every constant is the float32 value the plain version
    computes with: f32(0.5 k) and f32(c) of a trap, f32(g), the couplings
    f32(c_s) and the wall bounds of ``SlitWalls.bounds`` for each species.
    Raises NotImplementedError, naming the field, for one no kernel
    covers: more than MAX_FIELD_TERMS terms, a nested composite, a
    ``SpeciesField`` around other than a trap or a linear field, or a
    class the kernels do not know. Cached per field (fields are frozen):
    a sweep should not pay for the small tensor ops."""
    terms = field.fields if isinstance(field, fields.CompositeField) \
        else (field,)
    if len(terms) > MAX_FIELD_TERMS:
        raise NotImplementedError(
            f"the sub-step kernels' field form takes at most "
            f"{MAX_FIELD_TERMS} terms; {field!r} has {len(terms)}")
    fp = FieldParams(n=len(terms), energetic=int(field.has_energy))
    species = torch.tensor([0.0, 1.0])
    for i, f in enumerate(terms):
        t = fp.t[i]
        if isinstance(f, fields.SpeciesField):
            if not resolved:
                raise TypeError("SpeciesField is species-resolved; run it "
                                "through a mixture model")
            c = fields._select_by_species(f.couplings, species)
            t.species, t.coupling[:] = 1, c.tolist()
            f = f.base
        if isinstance(f, fields.HarmonicTrap):
            if f.dim != dim:
                raise ValueError(f"{f!r} is {f.dim}D in a {dim}D model")
            t.kind = 0
            t.k[:dim] = [_f32(0.5 * k) for k in f.stiffness]
            t.c[:dim] = [_f32(c) for c in f.center]
            fp.axes |= (1 << dim) - 1
        elif isinstance(f, fields.LinearField) and f.axis < dim:
            t.kind, t.axis, t.g, t.unit = 1, f.axis, _f32(f.g), f.g == 1.0
            fp.axes |= 1 << f.axis
        elif isinstance(f, fields.SlitWalls) and f.axis < dim:
            t.kind, t.axis = 2, f.axis
            fp.axes |= 1 << f.axis
            x = torch.zeros(dim, 2)
            lo, hi = f.bounds(x, species if resolved else None)
            t.lo[:] = lo.expand(2).tolist()
            t.hi[:] = hi.expand(2).tolist()
        else:
            raise NotImplementedError(
                f"no field form of the sub-step kernels covers {f!r} (in "
                f"{field!r}): they take traps, linear fields and slit walls"
                f" on an axis < {dim}, flat compositions of them, and per-"
                "species couplings of a trap or a linear field")
    return fp


def scale_squared(scale: torch.Tensor | float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """s^2 of the NPT box scale s as a 0-d tensor: f32(s * s), as the JAX
    package squares its float32 scale; in float64, the float32 s squared
    in float64."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device).to(dtype)
    return s * s


_STATE: dict[torch.device, torch.Tensor] = {}


def kernel_state(device: torch.device) -> torch.Tensor:
    """The sub-step kernels' int64 [4] buffer on ``device``: the counters
    of ``kernel_stats``, then the mixture kernel's cell counter and count
    of finished warps (its persistent grid), which each launch leaves at 0
    for the next; launches on one device run in turn on one stream."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STATE:
        _STATE[device] = torch.zeros(4, dtype=torch.int64, device=device)
    return _STATE[device]


def kernel_stats(device: torch.device) -> torch.Tensor:
    """The sub-step kernels' counters on ``device``, int64 [2], added to by
    every launch there: cells whose frozen slots overflowed the shared
    memory (they take a second pass from device memory; every kernel), and
    full pair terms evaluated (the energetic kernels). Reset with
    ``.zero_()``."""
    return kernel_state(device)[:2]


def kernel_shape(lib: CudaLibrary, nmax: int, cells: int = 0,
                 scaled: bool = False, field: bool = False,
                 philox: bool = False) -> dict:
    """The launch shape of a sub-step kernel at ``nmax`` on the current
    device (its NPT form if ``scaled``, its field form if ``field``, its
    Philox form if ``philox``), from
    the CUDA runtime: registers a thread, static and dynamic shared memory
    a block (bytes), local memory a thread (bytes), resident warps an SM
    and the staged frozen slots a warp (energetic kernels) or a thread
    (2D); for the 2D kernel also the blocks of its cooperative grid at
    ``cells`` cells a color."""
    keys = ["registers", "static_smem", "dynamic_smem", "local_bytes",
            "warps_per_sm", "staged_capacity"]
    form = 3 if philox else (2 if field else int(scaled))
    if lib is LIB and philox:
        lib, fn, args = LIB_PHILOX, "mcjax_substep_2d_philox_shape", (nmax,
                                                                     cells)
        keys.append("grid_blocks")
    elif lib is LIB and field:
        lib, fn, args = LIB_FIELD, "mcjax_substep_2d_field_shape", (nmax,
                                                                   cells)
        keys.append("grid_blocks")
    elif lib is LIB:
        fn, args = "mcjax_substep_2d_shape", (nmax, cells, form)
        keys.append("grid_blocks")
    else:
        fn = {"substep_lj": "mcjax_substep_lj3d_shape",
              "substep_mix": "mcjax_substep_mix3d_shape"}[lib.name]
        args = (nmax, form)
    out = (ctypes.c_int * len(keys))()
    err = getattr(lib.load(), fn)(*args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{lib.name}.{fn}: CUDA error {err}")
    return dict(zip(keys, out))


def squared_norm(d: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_k d_k^2 over ``axis`` as XLA-CPU computes ``jnp.sum(d*d, axis)``:
    a chain of fused multiply-adds, fma(d_1, d_1, d_0*d_0) in 2D and
    fma(d_2, d_2, fma(d_1, d_1, d_0*d_0)) in 3D (both measured,
    ``test_contraction_sites_match_xla``)."""
    parts = d.unbind(axis)
    r2 = parts[0] * parts[0]
    for dk in parts[1:]:
        r2 = fma_f32(dk, dk, r2)
    return r2


def cell_lower_bounds(cfg: SimConfig, color: int, bs: tuple[int, ...],
                      device: torch.device) -> torch.Tensor:
    """Lower corner of every active cell of ``color``, [dim, *bs]:
    fma(c_k, w, -L/2) in float32, as XLA-CPU computes it."""
    o = cells.color_bits(color, cfg.dim)
    w = torch.tensor(cfg.cell_width, dtype=torch.float32, device=device)
    neg_half = torch.tensor(-cfg.box_length / 2.0, dtype=torch.float32,
                            device=device)
    lbs = []
    for k in range(cfg.dim):
        ck = 2 * cells.block_index(bs, k, device) + o[k]
        lbs.append(fma_f32(ck.to(torch.float32), w, neg_half))
    return torch.stack(lbs, dim=0)


def color_substep(cfg: SimConfig, pot: Potential, color: int,
                  pos: torch.Tensor, occ: torch.Tensor, pick_u: torch.Tensor,
                  disp: torch.Tensor, acc_u: torch.Tensor | None = None,
                  record: dict | None = None, *,
                  scale: torch.Tensor | float | None = None,
                  field=None, origin: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """n_moves Metropolis moves in every cell of one color (plain version).

    Each move picks slot p = min(floor(u*occ), max(occ-1, 0)), proposes
    new = old + disp and rejects it if the cell is empty or new leaves the
    cell [lb, lb + w) on any axis. Hard-core models then reject an overlap
    with a valid slot of the own cell (other than p) or of the 8 (26 in 3D)
    frozen neighbor cells. Energetic models sum the pair energy e(x) of the
    mover over the same slots at old and new and accept when
    acc_u < exp(-beta (e(new) - e(old))); ``acc_u`` [n_moves, *bs] is then
    required. Under an NPT box ``scale`` s every squared distance is
    s^2 r2 (s^2 = f32(s * s)) before the overlap or the energy.

    An external ``field`` (``mcjax_torch.models.fields``) is evaluated at
    physical x = wrap(stored + ``origin``) (float32 [dim], zeros if None),
    as ``mcjax.ops.sweep.color_substep`` evaluates it: a move into its
    forbidden region is rejected, and a field with energy adds its term to
    dE, (dE + E(new)) - E(old), and makes even a hard-core model take the
    exp test (and need ``acc_u``).

    ``record``, if given, receives per-cell maps over [*bs]: ``de_cell``
    (the summed dE of accepted moves), ``in_cell`` (moves of a non-empty
    cell that stayed inside it, the ones that need pair work) and, for
    energetic models, ``margin`` (the smallest |acc_u - a| / a over those
    moves, a = exp(-beta dE): how close a decision came to a tie).

    Returns (new own-color block [dim, nmax, *bs], dE, accepted, proposed):
    dE is a 0-d float32 tensor (0 for hard-core models), the counts 0-d
    int64 tensors.
    """
    energetic = pot.has_energy
    nbrp, nbr_occ = cells.neighbor_stack(cfg, pos, occ, color)
    slot = torch.arange(cfg.nmax, device=pos.device).reshape(
        (cfg.nmax,) + (1,) * cfg.dim)
    nbr_valid = slot[None] < nbr_occ[:, None]          # [K, nmax, *bs]
    scaled = scaled_r2(scale, pos.device)

    def energy_at(x, ownp, valid_own, sel):
        """(energy, overlap) of a mover at x [dim, *bs] against its own
        cell's valid slots and the frozen neighbor slots."""
        r2_own = scaled(squared_norm(x[:, None] - ownp, 0))      # [nmax, *bs]
        e_o, ov_o = pair_interaction(pot, r2_own, valid_own)
        r2_nbr = scaled(squared_norm(x[None, :, None] - nbrp, 1))  # [K, nmax, *bs]
        e_n, ov_n = pair_interaction(pot, r2_nbr, nbr_valid)
        ov = ov_o.any(dim=0) | ov_n.any(dim=1).any(dim=0)
        if not energetic:
            return None, ov
        return e_o.sum(dim=0) + e_n.sum(dim=(0, 1)), ov

    return metropolis_moves(cfg, color, pos[color], occ[color], pick_u, disp,
                            acc_u, energy_at, energetic, record,
                            field=field, origin=origin)


def scaled_r2(scale: torch.Tensor | float | None, device: torch.device):
    """r2 -> s^2 r2 in float32 (s^2 = ``scale_squared``), as the JAX
    package's sub-step computes ``s2 * r2``; the identity without a
    scale."""
    if scale is None:
        return lambda r2: r2
    s2 = scale_squared(scale, torch.float32, device)
    return lambda r2: s2 * r2


def metropolis_moves(cfg: SimConfig, color: int, ownp: torch.Tensor,
                     own_occ: torch.Tensor, pick_u: torch.Tensor,
                     disp: torch.Tensor, acc_u: torch.Tensor | None,
                     energy_at, energetic: bool, record: dict | None, *,
                     field=None, origin: torch.Tensor | None = None,
                     ownspec: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The move loop ``color_substep`` and the mixture sub-step share.

    ``ownp`` [dim, nmax, *bs] are the coordinates of the color's cells and
    ``energy_at(x, ownp, valid_own, sel)`` returns the mover's (energy or
    None, overlap) at x, given the current own coordinates, the own slots
    it interacts with and the one-hot mask of the mover's slot; its energy
    is None unless ``energetic``. ``field`` / ``origin`` are
    ``color_substep``'s; with ``ownspec`` (the own cells' species plane,
    [nmax, *bs]) the field is species-resolved in the mixture sub-step's
    order, dE + (E_s(new) - E_s(old)). Returns (new ownp, dE, accepted,
    proposed) and fills ``record`` as ``color_substep`` documents; a move
    into the field's forbidden region counts as one that left its cell.
    """
    field_energy = field is not None and field.has_energy
    if (energetic or field_energy) and acc_u is None:
        raise ValueError("an energetic model or field needs acceptance "
                         "uniforms")
    nmax, n_m = cfg.nmax, cfg.n_moves
    dev = ownp.device
    bs = tuple(own_occ.shape)
    lbp = cell_lower_bounds(cfg, color, bs, dev)       # [dim, *bs]
    hip = lbp + cfg.cell_width

    slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * len(bs))
    own_valid = slot < own_occ[None]                   # [nmax, *bs]
    nonempty = own_occ > 0
    occ_f = own_occ.to(torch.float32)
    p_max = torch.clamp(own_occ - 1, min=0)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    de_sum = torch.zeros((), dtype=torch.float32, device=dev)
    de_cell = torch.zeros(bs, dtype=torch.float32, device=dev)
    in_cell = torch.zeros(bs, dtype=torch.int32, device=dev)
    margin = torch.full(bs, float("inf"), dtype=torch.float32, device=dev)
    if field is not None:
        if origin is None:
            origin = torch.zeros(cfg.dim, dtype=torch.float32, device=dev)
        org = origin.reshape((cfg.dim,) + (1,) * len(bs))

    for m in range(n_m):
        p = torch.floor(pick_u[m] * occ_f).to(torch.int64)
        p = torch.minimum(p, p_max)
        sel = slot == p[None]                          # [nmax, *bs]
        idx = p[None, None].expand((ownp.shape[0], 1) + bs)
        old = torch.gather(ownp, 1, idx).squeeze(1)    # [dim, *bs]
        new = old + disp[m]
        oob = ((new < lbp) | (new >= hip)).any(dim=0)
        valid_own = own_valid & ~sel

        e_new, ov = energy_at(new, ownp, valid_own, sel)
        live = nonempty & ~oob
        if field is not None:
            sx = None if ownspec is None else \
                torch.where(sel, ownspec, 0.0).sum(dim=0)
            px_new = wrap_into_box(new + org, cfg.box_length)
            live = live & ~fields.species_forbidden(field, px_new, sx)
        accept = live & ~ov
        if energetic or field_energy:
            de = None
            if energetic:
                e_old, _ = energy_at(old, ownp, valid_own, sel)
                de = e_new - e_old
            if field_energy:
                px_old = wrap_into_box(old + org, cfg.box_length)
                de = fields.field_delta(field, de, px_new, px_old, sx)
            a = torch.exp(-cfg.beta * de)
            accept = accept & (acc_u[m] < a)
            de_acc = torch.where(accept, de, 0.0)
            de_sum = de_sum + de_acc.sum()
            de_cell = de_cell + de_acc
            rel = (acc_u[m] - a).abs() / a
            margin = torch.where(live, torch.fmin(margin, rel), margin)
        ownp = torch.where((accept[None] & sel)[None], new[:, None], ownp)
        n_acc = n_acc + accept.sum()
        in_cell = in_cell + live.to(torch.int32)
    n_prop = n_m * nonempty.sum()
    if record is not None:
        record.update(de_cell=de_cell, in_cell=in_cell)
        if energetic or field_energy:
            record["margin"] = margin
    return ownp, de_sum, n_acc, n_prop


def kernel_library(cfg: SimConfig, pot: Potential) -> CudaLibrary:
    """The CUDA library whose kernel runs this configuration's sub-step;
    raises NotImplementedError for one no kernel covers."""
    if cfg.dim == 2 and isinstance(pot, HardSphere):
        if cfg.nmax > KERNEL_NMAX:
            raise NotImplementedError(
                f"the 2D disk sub-step kernel is built for nmax <= "
                f"{KERNEL_NMAX}")
        return LIB
    if cfg.dim == 3 and isinstance(pot, LennardJones):
        if cfg.nmax > KERNEL_NMAX_LJ:
            raise NotImplementedError(
                f"the 3D LJ sub-step kernel is built for nmax <= "
                f"{KERNEL_NMAX_LJ}")
        return LIB_LJ
    if cfg.dim == 3 and isinstance(pot, LJMixture):
        if not pot.supports_mover_hoist:
            raise NotImplementedError(
                f"the 3D mixture sub-step kernel covers binary LJ mixtures "
                f"with one cutoff ratio r_cut / sigma for every pair; this "
                f"one has {pot.n_species} species and cutoff ratio squared "
                f"{pot._uniform_cutoff_ratio2()}")
        if cfg.nmax > KERNEL_NMAX_MIX:
            raise NotImplementedError(
                f"the 3D mixture sub-step kernel is built for nmax <= "
                f"{KERNEL_NMAX_MIX}")
        return LIB_MIX
    raise NotImplementedError(
        f"no CUDA sub-step kernel for a {cfg.dim}D {type(pot).__name__} "
        "model: the kernels cover 2D hard disks, 3D Lennard-Jones and 3D "
        "binary LJ mixtures")


Draw = tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]


def substeps(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
             occ: torch.Tensor, perm: torch.Tensor,
             draws: list[Draw] | PhiloxKey, start: int = 0,
             scale: torch.Tensor | float | None = None,
             field=None, origin: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sub-steps [start, start + n) of a sweep, n = len(draws): sub-step j
    works on color perm[j] with draws[j - start] = (pick_u, disp, acc_u);
    updates ``pos`` IN PLACE. ``draws`` may instead be a ``PhiloxKey``:
    then the sub-steps [start, n_colors) take the keyed stream's draws,
    generated in the kernels' Philox forms on CUDA and materialized by
    ``PhiloxRandoms`` for the plain version on the CPU (sub-step j's cells
    keyed by color perm[j]). On CUDA a key with a ``field`` or a ``scale``
    raises NotImplementedError: no Philox form covers them.

    In place is safe: a sub-step writes only its own color block and reads
    the others, and checkerboard neighbors are always other colors. Returns
    (dE, accepted, proposed) of each sub-step as [n] tensors (float32,
    int64, int64) on pos's device; energetic models need every ``acc_u``.
    On a CPU tensor this runs the plain version once per sub-step; on a
    CUDA tensor the 2D disk kernel runs the range in one launch and the
    energetic kernels launch once per sub-step, each reading its color
    from device memory (no host sync). A mixture's ``pos`` carries the
    species plane after the coordinates (dim + 1 planes). ``scale`` (a 0-d
    float32 tensor on pos's device, or a float) is the NPT box scale: the
    kernels' NPT forms then read s^2 from device memory, so a scale that
    changes on the device every sweep costs no host sync. An external
    ``field`` (``mcjax_torch.models.fields``) at frame ``origin`` (float32
    [dim] on pos's device; zeros if None) runs the kernels' field forms,
    which read the origin from device memory likewise; a field with energy
    needs every ``acc_u``, even over hard disks. A field does not combine
    with a scale (the JAX package has no NPT run under a field).
    """
    bs = cfg.block_shape
    mixture = getattr(pot, "is_mixture", False)
    planes = cfg.dim + 1 if mixture else cfg.dim
    key = draws if isinstance(draws, PhiloxKey) else None
    n = cfg.n_colors - start if key is not None else len(draws)
    need_acc = pot.has_energy or (field is not None and field.has_energy)
    if n < 1 or start < 0 or start + n > cfg.n_colors:
        raise ValueError(f"sub-steps [{start}, {start + n}) outside "
                         f"[0, {cfg.n_colors})")
    want = {
        "pos": (pos, torch.float32, (cfg.n_colors, planes, cfg.nmax, *bs)),
        "occ": (occ, torch.int32, (cfg.n_colors, *bs)),
        "perm": (perm, torch.int32, (cfg.n_colors,)),
    }
    for j, (pick_u, disp, acc_u) in enumerate(draws if key is None else []):
        want[f"pick_u[{j}]"] = (pick_u, torch.float32, (cfg.n_moves, *bs))
        want[f"disp[{j}]"] = (disp, torch.float32,
                              (cfg.n_moves, cfg.dim, *bs))
        if need_acc:
            if acc_u is None:
                raise ValueError("an energetic model or field needs "
                                 "acceptance uniforms")
            want[f"acc_u[{j}]"] = (acc_u, torch.float32, (cfg.n_moves, *bs))
    if isinstance(scale, torch.Tensor):
        want["scale"] = (scale, torch.float32, ())
    if field is not None:
        if scale is not None:
            raise NotImplementedError(
                "an external field under an NPT box scale: the JAX package "
                "has no such run, and no kernel form covers it")
        if origin is None:
            origin = torch.zeros(cfg.dim, dtype=torch.float32,
                                 device=pos.device)
        want["origin"] = (origin, torch.float32, (cfg.dim,))
    check_tensors(pos.device, want)
    dev = pos.device
    if dev.type == "cpu":
        if key is not None:
            rnd = PhiloxRandoms(key.seed, dev, key.ih_k)
            draws = [rnd.move_draws(cfg, key.sweep, start + j,
                                    int(perm[start + j]), need_acc)
                     for j in range(n)]
        if mixture:
            # ops.mixture builds on this module, so it is imported here
            from mcjax_torch.ops.mixture import color_substep_mixture
            plain = color_substep_mixture
        else:
            plain = color_substep
        outs = []
        for j, draw in enumerate(draws):
            color = int(perm[start + j])
            own_new, *out = plain(cfg, pot, color, pos, occ, *draw,
                                  scale=scale, field=field, origin=origin)
            pos[color] = own_new
            outs.append(out)
        de, acc, prop = (torch.stack(t) for t in zip(*outs))
        return de, acc, prop
    lib = kernel_library(cfg, pot)
    if dev.type != "cuda":
        raise ValueError(f"no sub-step for device {dev}")
    ph = None
    if key is not None:
        if field is not None:
            raise NotImplementedError(
                "no Philox form of the sub-step kernels takes an external "
                "field yet (ROADMAP B3): run a field with materialized draws "
                "(TorchRandoms)")
        if scale is not None:
            raise NotImplementedError(
                "no Philox form of the sub-step kernels takes an NPT box "
                "scale (the JAX package has no in-kernel-RNG NPT run): run "
                "NPT with materialized draws (TorchRandoms)")
        ph = philox_args(cfg, key, need_acc)
        draws = [(None, None, None)] * n
    s2 = None if scale is None else scale_squared(scale, torch.float32, dev)
    fk = None if field is None else \
        FieldKernel(field_params(field, cfg.dim, lib is LIB_MIX), origin)
    if lib is LIB:
        counts = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        de = torch.zeros(n, dtype=torch.float32, device=dev)
        if ph is not None:
            launch_philox_kernel(cfg, pot, pos, occ, perm, start, n, ph,
                                 counts)
        elif fk is None:
            launch_kernel(cfg, pot, pos, occ, perm, start,
                          [d[0] for d in draws], [d[1] for d in draws],
                          counts, s2)
        else:
            de_map = torch.zeros((n, *bs), dtype=torch.float32, device=dev)
            launch_field_kernel(cfg, pot, pos, occ, perm, start, draws,
                                counts, de_map, fk)
            de = de_map.flatten(1).sum(1)
        return de, counts[:, 0], counts[:, 1]
    de_map = torch.empty((n, *bs), dtype=torch.float32, device=dev)
    acc_map = torch.empty((n, *bs), dtype=torch.int32, device=dev)
    launch = launch_lj_kernel if lib is LIB_LJ else launch_mix_kernel
    for j, (pick_u, disp, acc_u) in enumerate(draws):
        launch(cfg, pot, pos, occ, perm, start + j, pick_u, disp, acc_u,
               de_map[j], acc_map[j], s2, fk, ph)
    color_occ = occ.index_select(0, perm[start:start + n])
    proposed = cfg.n_moves * (color_occ > 0).flatten(1).sum(1)
    return (de_map.flatten(1).sum(1),
            acc_map.flatten(1).sum(1, dtype=torch.int64), proposed)


def substep(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
            occ: torch.Tensor, perm: torch.Tensor, i: int,
            pick_u: torch.Tensor, disp: torch.Tensor,
            acc_u: torch.Tensor | None = None,
            scale: torch.Tensor | float | None = None,
            field=None, origin: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sub-step i of a sweep, color perm[i]: ``substeps`` with a range of
    one (one launch on CUDA), at box scale ``scale`` or under ``field`` at
    frame ``origin``. Returns (dE, accepted, proposed) as 0-d tensors
    (float32, int64, int64) on pos's device."""
    de, acc, prop = substeps(cfg, pot, pos, occ, perm,
                             [(pick_u, disp, acc_u)], start=i, scale=scale,
                             field=field, origin=origin)
    return de[0], acc[0], prop[0]


class FieldKernel(NamedTuple):
    """A field form's launch arguments: the field's ``FieldParams`` (host
    memory, copied into the launch) and the frame origin (float32 [dim] on
    the device, read by the kernel)."""
    params: FieldParams
    origin: torch.Tensor


def s2_pointer(s2: torch.Tensor | None) -> int | None:
    """The device pointer to a float32 s^2 (0-d) that selects a kernel's
    NPT form, or None (a null pointer: the NVT form)."""
    return None if s2 is None else s2.data_ptr()


def launch_kernel(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                  occ: torch.Tensor, perm: torch.Tensor, start: int,
                  pick_us: list[torch.Tensor], disps: list[torch.Tensor],
                  counts: torch.Tensor, s2: torch.Tensor | None = None
                  ) -> None:
    """One cooperative launch of the 2D disk kernel on inputs ``substeps``
    has checked: sub-steps [start, start + len(pick_us)), in place on pos,
    adding each sub-step's accepted and proposed moves to ``counts``
    (int64 [n, 2], zeroed by the caller) and the cells that took the
    overflow pass to ``kernel_stats``. ``s2`` (float32 0-d on the device)
    selects the NPT form, which reads s^2 from it."""
    h, w = cfg.block_shape
    n = len(pick_us)
    ptrs = ctypes.c_void_p * n
    LIB.launch(
        "mcjax_substep_2d",
        pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), start, n,
        ptrs(*(t.data_ptr() for t in pick_us)),
        ptrs(*(t.data_ptr() for t in disps)),
        counts.data_ptr(), kernel_state(pos.device).data_ptr(),
        h, w, cfg.nmax, cfg.n_moves,
        cfg.cell_width, cfg.box_length / 2.0, cfg.box_length,
        pot.diameter * pot.diameter, *cull_constants(cfg, pot.diameter),
        s2_pointer(s2), torch.cuda.current_stream(pos.device).cuda_stream,
        npt=s2 is not None)


def launch_philox_kernel(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                         occ: torch.Tensor, perm: torch.Tensor, start: int,
                         n: int, ph: PhiloxArgs, counts: torch.Tensor
                         ) -> None:
    """One cooperative launch of the 2D disk kernel's Philox form:
    ``launch_kernel`` with the draws of sub-steps [start, start + n)
    generated in the kernel from ``ph`` (``philox_args``)."""
    h, w = cfg.block_shape
    LIB_PHILOX.launch(
        "mcjax_substep_2d_philox",
        pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), start, n,
        counts.data_ptr(), kernel_state(pos.device).data_ptr(),
        h, w, cfg.nmax, cfg.n_moves,
        cfg.cell_width, cfg.box_length / 2.0, cfg.box_length,
        pot.diameter * pot.diameter, *cull_constants(cfg, pot.diameter),
        ctypes.addressof(ph),
        torch.cuda.current_stream(pos.device).cuda_stream, philox=True)


def launch_field_kernel(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                        occ: torch.Tensor, perm: torch.Tensor, start: int,
                        draws: list[Draw], counts: torch.Tensor,
                        de_map: torch.Tensor, fk: FieldKernel) -> None:
    """One cooperative launch of the 2D disk kernel's field form on inputs
    ``substeps`` has checked: ``launch_kernel`` under the field ``fk``,
    also writing each cell's summed dE of accepted moves into de_map[j]
    (float32 [n, H, W]) when the field has energy, whose acceptance
    uniforms (each draw's acc_u) it then reads."""
    h, w = cfg.block_shape
    n = len(draws)
    ptrs = ctypes.c_void_p * n
    LIB_FIELD.launch(
        "mcjax_substep_2d_field",
        pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), start, n,
        ptrs(*(d[0].data_ptr() for d in draws)),
        ptrs(*(d[1].data_ptr() for d in draws)),
        counts.data_ptr(), kernel_state(pos.device).data_ptr(),
        h, w, cfg.nmax, cfg.n_moves,
        cfg.cell_width, cfg.box_length / 2.0, cfg.box_length,
        pot.diameter * pot.diameter, *cull_constants(cfg, pot.diameter),
        ctypes.addressof(fk.params), fk.origin.data_ptr(),
        ptrs(*(0 if d[2] is None else d[2].data_ptr() for d in draws)),
        de_map.data_ptr(), -cfg.beta,
        torch.cuda.current_stream(pos.device).cuda_stream, field=True)


def launch_lj_kernel(cfg: SimConfig, pot: LennardJones, pos: torch.Tensor,
                     occ: torch.Tensor, perm: torch.Tensor, i: int,
                     pick_u: torch.Tensor, disp: torch.Tensor,
                     acc_u: torch.Tensor, de_map: torch.Tensor,
                     acc_map: torch.Tensor, s2: torch.Tensor | None = None,
                     fk: FieldKernel | None = None,
                     ph: PhiloxArgs | None = None) -> None:
    """One launch of the 3D LJ kernel on inputs ``substep`` has checked:
    updates pos[perm[i]] in place and writes each cell's summed dE of
    accepted moves into ``de_map`` (float32 [*bs]) and its accept count into
    ``acc_map`` (int32 [*bs]); adds to ``kernel_stats``. The model's
    constants go in as the float32 values the plain version rounds them
    to. ``s2`` selects the NPT form, as for ``launch_kernel``; ``fk`` the
    field form; ``ph`` (``philox_args``) the Philox form, which takes no
    draws (pick_u, disp and acc_u are then ignored)."""
    model = (cfg.half_cps, cfg.nmax, cfg.n_moves,
             cfg.cell_width, cfg.box_length / 2.0, cfg.box_length, cfg.beta,
             pot.sigma * pot.sigma, 4.0 * pot.epsilon, pot.shift_value,
             pot.r_cut * pot.r_cut, *cull_constants(cfg, pot.r_cut))
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    head = (pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), i)
    maps = (de_map.data_ptr(), acc_map.data_ptr(),
            kernel_state(pos.device).data_ptr())
    if ph is not None:
        LIB_LJ.launch("mcjax_substep_lj3d_philox", *head, *maps, *model,
                      ctypes.addressof(ph), stream, philox=True)
        return
    args = (*head, pick_u.data_ptr(), disp.data_ptr(), acc_u.data_ptr(),
            *maps, *model)
    if fk is not None:
        LIB_LJ.launch("mcjax_substep_lj3d_field", *args,
                      ctypes.addressof(fk.params), fk.origin.data_ptr(),
                      stream, field=True)
        return
    LIB_LJ.launch("mcjax_substep_lj3d", *args, s2_pointer(s2), stream,
                  npt=s2 is not None)


@functools.lru_cache(maxsize=None)
def mixture_constants(pot: LJMixture) -> tuple[float, ...]:
    """The mixture kernel's constants: f32 blends of sigma^2 and 4 eps at
    u = s_i + s_j = 0, 1, 2, computed by the plain version's own float32
    operations, the candidate bounds on r2 (each pair's cutoff^2 grown by
    CULL_REL), then the shift constant and the cutoff ratio squared.
    Cached per model: a launch should not pay for the small tensor ops."""
    ce4, cs2, _, _ = pot._binary_coeffs()
    u = torch.tensor([0.0, 1.0, 2.0])
    u2 = u * u
    sig2 = _blend(cs2, u, u2).tolist()
    c2 = pot._uniform_cutoff_ratio2()
    cand2 = [s2 * c2 * (1.0 + CULL_REL) ** 2 for s2 in sig2]
    return (*sig2, *_blend(ce4, u, u2).tolist(), *cand2,
            pot.uniform_shift_constant, c2)


def launch_mix_kernel(cfg: SimConfig, pot: LJMixture, pos: torch.Tensor,
                      occ: torch.Tensor, perm: torch.Tensor, i: int,
                      pick_u: torch.Tensor, disp: torch.Tensor,
                      acc_u: torch.Tensor, de_map: torch.Tensor,
                      acc_map: torch.Tensor, s2: torch.Tensor | None = None,
                      fk: FieldKernel | None = None,
                      ph: PhiloxArgs | None = None) -> None:
    """One launch of the 3D mixture kernel on inputs ``substep`` has
    checked: updates the coordinates of pos[perm[i]] in place and writes
    each cell's summed dE of accepted moves into ``de_map`` and its accept
    count into ``acc_map``, and adds to ``kernel_stats``, as
    ``launch_lj_kernel`` does (``s2``, ``fk`` and ``ph`` likewise; the
    field is species-resolved)."""
    model = (cfg.half_cps, cfg.nmax, cfg.n_moves,
             cfg.cell_width, cfg.box_length / 2.0, cfg.box_length, cfg.beta,
             *mixture_constants(pot), *cull_constants(cfg, pot.r_cut))
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    head = (pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), i)
    maps = (de_map.data_ptr(), acc_map.data_ptr(),
            kernel_state(pos.device).data_ptr())
    if ph is not None:
        LIB_MIX.launch("mcjax_substep_mix3d_philox", *head, *maps, *model,
                       ctypes.addressof(ph), stream, philox=True)
        return
    args = (*head, pick_u.data_ptr(), disp.data_ptr(), acc_u.data_ptr(),
            *maps, *model)
    if fk is not None:
        LIB_MIX.launch("mcjax_substep_mix3d_field", *args,
                       ctypes.addressof(fk.params), fk.origin.data_ptr(),
                       stream, field=True)
        return
    LIB_MIX.launch("mcjax_substep_mix3d", *args, s2_pointer(s2), stream,
                   npt=s2 is not None)
