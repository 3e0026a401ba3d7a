"""Checkerboard Metropolis sweep engine (twin of ``mcjax.ops.sweep``).

One sweep runs the 2^dim color sub-steps in the provider's shuffled order,
then one random grid shift. A mixture state (a species plane after the
coordinates) runs through the same loop: ``cuda_substep.substep`` picks the
mixture sub-step, as the JAX package's ``mc_sweep`` picks
``color_substep_mixture``, and the shift carries the species plane. On
CUDA the sub-steps and the shift run in hand-written kernels
(``cuda_substep``, ``cuda_shift``): for 2D disks all sub-steps of a sweep
are one launch, for the energetic models each sub-step is one, and the
shift is one; on the CPU the same wrappers run their plain PyTorch
versions.

A run on CUDA makes no host sync per sweep: the color order, the shift
axis and distance are device tensors the kernels read, the metrics stay on
the device and are stacked once at the end.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.geometry import min_image
from mcjax_torch.core.state import SimState
from mcjax_torch.models.potentials import Potential, pair_interaction
from mcjax_torch.ops import cells, cuda_shift, cuda_substep, mixture
from mcjax_torch.ops.cuda_substep import color_substep, scale_squared
from mcjax_torch.ops.random import RandomProvider

__all__ = ["SweepMetrics", "cell_pairs", "color_substep", "mc_sweep",
           "min_pair_distance", "run_sweeps", "scale_squared",
           "total_energy_cells", "total_interaction",
           "total_interaction_cells"]


class SweepMetrics(NamedTuple):
    """Per-sweep observables, tensors on the state's device."""

    delta_e: torch.Tensor    # summed dE of accepted moves (float32)
    accepted: torch.Tensor   # accepted moves (int64)
    proposed: torch.Tensor   # proposals in non-empty cells (int64)
    overflow: torch.Tensor   # grid-shift capacity violation this sweep (bool)


def mc_sweep(cfg: SimConfig, pot: Potential, state: SimState,
             randoms: RandomProvider, scale: torch.Tensor | None = None,
             field=None, origin: torch.Tensor | None = None
             ) -> tuple[SimState, SweepMetrics]:
    """One full MC sweep: shuffled color sub-steps, then a grid shift.

    The draws of every sub-step are taken first, in sub-step order, then
    the sub-steps run in one ``cuda_substep.substeps`` call. They update
    ``state.pos`` IN PLACE (the caller's state is consumed); the shift
    writes new buffers, which the returned state holds. ``scale`` (a 0-d
    float32 tensor on the state's device, or None) is the NPT box scale s
    of the JAX package's stored-frame convention: pair distances are
    s^2 r~^2 (``mcjax_torch.ops.npt``). An external ``field`` is evaluated
    at physical x = wrap(stored + ``origin``); the sweep does not move the
    origin (``mcjax_torch.ops.extfield.field_sweep`` does, with the same
    shift).
    """
    new_state, m, _ = sweep_with_schedule(cfg, pot, state, randoms, scale,
                                          field, origin)
    return new_state, m


def sweep_with_schedule(cfg: SimConfig, pot: Potential, state: SimState,
                        randoms: RandomProvider,
                        scale: torch.Tensor | None = None, field=None,
                        origin: torch.Tensor | None = None
                        ) -> tuple[SimState, SweepMetrics,
                                   tuple[torch.Tensor, torch.Tensor]]:
    """``mc_sweep``, also returning the sweep's shift draws (axis, d) as
    device tensors."""
    perm, axis, d = randoms.schedule(cfg, state.sweep)
    pos, occ = state.pos, state.occ
    need_acc = pot.has_energy or (field is not None and field.has_energy)
    draws = [randoms.substep(cfg, state.sweep, i, need_acc=need_acc)
             for i in range(cfg.n_colors)]
    de, acc, prop = cuda_substep.substeps(cfg, pot, pos, occ, perm, draws,
                                          scale=scale, field=field,
                                          origin=origin)
    if (state.sweep + 1) % cfg.shift_every == 0:
        pos, occ, ovf = cuda_shift.shift(cfg, pos, occ, axis, d)
    else:
        ovf = torch.zeros((), dtype=torch.bool, device=pos.device)
    new_state = SimState(pos=pos, occ=occ, sweep=state.sweep + 1,
                         overflow=state.overflow | ovf)
    return (new_state, SweepMetrics(de.sum(), acc.sum(), prop.sum(), ovf),
            (axis, d))


def run_sweeps(cfg: SimConfig, pot: Potential, state: SimState,
               n_sweeps: int, randoms: RandomProvider,
               scale: torch.Tensor | None = None
               ) -> tuple[SimState, SweepMetrics]:
    """Run ``n_sweeps`` sweeps at the fixed box scale ``scale`` (None:
    NVT); metrics stacked per sweep ([n_sweeps] each).

    Consumes ``state`` (see ``mc_sweep``).
    """
    ms = []
    for _ in range(n_sweeps):
        state, m = mc_sweep(cfg, pot, state, randoms, scale)
        ms.append(m)
    stacked = SweepMetrics(*(torch.stack(field) for field in zip(*ms)))
    return state, stacked


def cell_pairs(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
               dtype: torch.dtype = torch.float32,
               scale: torch.Tensor | float | None = None
               ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Every pair of live slots in one cell or in neighboring cells.

    Yields (r2, valid) blocks, one intra-cell and one cross-cell block per
    color: minimum-image squared distances computed in ``dtype`` (times
    s^2 = ``scale_squared(scale)`` under an NPT box scale) and the mask of
    pairs of live, distinct slots. Each pair appears twice. Only the
    coordinate planes are read (a mixture's species plane is not).
    """
    nmax, dim = cfg.nmax, cfg.dim
    dev = pos.device
    box = float(torch.tensor(cfg.box_length, dtype=torch.float32))
    s2 = None if scale is None else scale_squared(scale, dtype, dev)

    def scaled(r2):
        return r2 if s2 is None else s2 * r2

    for color in range(cfg.n_colors):
        own = pos[color, :dim].to(dtype)                   # [dim, nmax, *bs]
        own_occ = occ[color]                               # [*bs]
        bs = tuple(own_occ.shape)
        slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * len(bs))
        valid_i = slot < own_occ[None]                     # [nmax, *bs]
        d = min_image(own[:, :, None] - own[:, None, :], box)
        not_self = ~torch.eye(nmax, dtype=torch.bool, device=dev).reshape(
            (nmax, nmax) + (1,) * len(bs))
        yield (scaled((d * d).sum(dim=0)),                 # [nmax, nmax, *bs]
               valid_i[:, None] & valid_i[None, :] & not_self)
        # the float32 pass unwraps neighbors as the JAX package does; a float64
        # pass differences the stored coordinates with no float32 add
        nbr_pos, nbr_occ = cells.neighbor_stack(
            cfg, pos, occ, color, unwrap=dtype == torch.float32)
        valid_j = slot[None] < nbr_occ[:, None]            # [K, nmax, *bs]
        dx = min_image(own[None, :, :, None]
                       - nbr_pos[:, :dim].to(dtype)[:, :, None, :], box)
        yield (scaled((dx * dx).sum(dim=1)),               # [K, nmax, nmax, *bs]
               valid_i[None, :, None] & valid_j[:, None, :])


def total_interaction_cells(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                            occ: torch.Tensor, dtype: torch.dtype = torch.float32,
                            scale: torch.Tensor | float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total energy, any hard-core overlap) via cell lists.

    E = 1/2 sum_i sum_{j in ring(i), j != i} e_ij; O(N * 3^dim * nmax), so
    it runs at a million particles. In float32 this is the JAX package's
    computation; ``dtype=torch.float64`` differences the stored float32
    coordinates, evaluates the pair terms and sums in float64, so a total
    over a million particles is not limited by float32. ``scale`` is the
    NPT box scale (pair distances s^2 r~^2, ``cell_pairs``).
    """
    total = torch.zeros((), dtype=dtype, device=pos.device)
    any_ov = torch.zeros((), dtype=torch.bool, device=pos.device)
    for r2, valid in cell_pairs(cfg, pos, occ, dtype, scale):
        e, ov = pair_interaction(pot, r2, valid)
        total = total + 0.5 * e.sum()
        any_ov = any_ov | ov.any()
    return total, any_ov


def total_interaction(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                      occ: torch.Tensor, dtype: torch.dtype = torch.float32,
                      scale: torch.Tensor | float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total energy, any overlap) via cell lists at box scale ``scale``:
    ``total_interaction_cells``, or
    ``mixture.total_interaction_cells_mixture`` for a mixture."""
    if getattr(pot, "is_mixture", False):
        return mixture.total_interaction_cells_mixture(cfg, pot, pos, occ,
                                                       dtype, scale)
    return total_interaction_cells(cfg, pot, pos, occ, dtype, scale)


def total_energy_cells(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                       occ: torch.Tensor, dtype: torch.dtype = torch.float32,
                       scale: torch.Tensor | float | None = None
                       ) -> torch.Tensor:
    """Total energy via cell lists (``total_interaction``): the anchor
    that the summed dE of a run is held against."""
    return total_interaction(cfg, pot, pos, occ, dtype, scale)[0]


def min_pair_distance(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor
                      ) -> float:
    """Smallest distance between two live particles, via cell lists, with
    the stored float32 coordinates differenced in float64."""
    best = torch.tensor(float("inf"), dtype=torch.float64, device=pos.device)
    for r2, valid in cell_pairs(cfg, pos, occ, torch.float64):
        best = torch.minimum(best, torch.where(valid, r2, float("inf")).min())
    return float(best.sqrt())
