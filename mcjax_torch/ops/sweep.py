"""Checkerboard Metropolis sweep engine (twin of ``mcjax.ops.sweep``).

One sweep runs the 2^dim color sub-steps in the provider's shuffled order,
then one random grid shift. A mixture state (a species plane after the
coordinates) runs through the same loop: ``cuda_substep.substep`` picks the
mixture sub-step, as the JAX package's ``mc_sweep`` picks
``color_substep_mixture``, and the shift carries the species plane. On CUDA every sub-step and every shift is one
launch of a hand-written kernel (``cuda_substep``, ``cuda_shift``); on the
CPU the same wrappers run their plain PyTorch versions.

A run on CUDA makes no host sync per sweep: the active color, the shift
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
from mcjax_torch.ops.cuda_substep import color_substep
from mcjax_torch.ops.random import RandomProvider

__all__ = ["SweepMetrics", "cell_pairs", "color_substep", "mc_sweep",
           "min_pair_distance", "run_sweeps", "total_energy_cells",
           "total_interaction_cells"]


class SweepMetrics(NamedTuple):
    """Per-sweep observables, tensors on the state's device."""

    delta_e: torch.Tensor    # summed dE of accepted moves (float32)
    accepted: torch.Tensor   # accepted moves (int64)
    proposed: torch.Tensor   # proposals in non-empty cells (int64)
    overflow: torch.Tensor   # grid-shift capacity violation this sweep (bool)


def mc_sweep(cfg: SimConfig, pot: Potential, state: SimState,
             randoms: RandomProvider) -> tuple[SimState, SweepMetrics]:
    """One full MC sweep: shuffled color sub-steps, then a grid shift.

    The sub-steps update ``state.pos`` IN PLACE (the caller's state is
    consumed); the shift writes new buffers, which the returned state holds.
    """
    perm, axis, d = randoms.schedule(cfg, state.sweep)
    pos, occ = state.pos, state.occ
    de = torch.zeros((), dtype=torch.float32, device=pos.device)
    n_acc = torch.zeros((), dtype=torch.int64, device=pos.device)
    n_prop = torch.zeros((), dtype=torch.int64, device=pos.device)
    for i in range(cfg.n_colors):
        pick_u, disp, acc_u = randoms.substep(cfg, state.sweep, i,
                                              need_acc=pot.has_energy)
        de_i, acc, prop = cuda_substep.substep(cfg, pot, pos, occ, perm, i,
                                               pick_u, disp, acc_u)
        de = de + de_i
        n_acc = n_acc + acc
        n_prop = n_prop + prop
    if (state.sweep + 1) % cfg.shift_every == 0:
        pos, occ, ovf = cuda_shift.shift(cfg, pos, occ, axis, d)
    else:
        ovf = torch.zeros((), dtype=torch.bool, device=pos.device)
    new_state = SimState(pos=pos, occ=occ, sweep=state.sweep + 1,
                         overflow=state.overflow | ovf)
    return new_state, SweepMetrics(de, n_acc, n_prop, ovf)


def run_sweeps(cfg: SimConfig, pot: Potential, state: SimState,
               n_sweeps: int, randoms: RandomProvider
               ) -> tuple[SimState, SweepMetrics]:
    """Run ``n_sweeps`` sweeps; metrics stacked per sweep ([n_sweeps] each).

    Consumes ``state`` (see ``mc_sweep``).
    """
    ms = []
    for _ in range(n_sweeps):
        state, m = mc_sweep(cfg, pot, state, randoms)
        ms.append(m)
    stacked = SweepMetrics(*(torch.stack(field) for field in zip(*ms)))
    return state, stacked


def cell_pairs(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
               dtype: torch.dtype = torch.float32
               ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Every pair of live slots in one cell or in neighboring cells.

    Yields (r2, valid) blocks, one intra-cell and one cross-cell block per
    color: minimum-image squared distances computed in ``dtype`` and the
    mask of pairs of live, distinct slots. Each pair appears twice. Only
    the coordinate planes are read (a mixture's species plane is not).
    """
    nmax, dim = cfg.nmax, cfg.dim
    dev = pos.device
    box = float(torch.tensor(cfg.box_length, dtype=torch.float32))
    for color in range(cfg.n_colors):
        own = pos[color, :dim].to(dtype)                   # [dim, nmax, *bs]
        own_occ = occ[color]                               # [*bs]
        bs = tuple(own_occ.shape)
        slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * len(bs))
        valid_i = slot < own_occ[None]                     # [nmax, *bs]
        d = min_image(own[:, :, None] - own[:, None, :], box)
        not_self = ~torch.eye(nmax, dtype=torch.bool, device=dev).reshape(
            (nmax, nmax) + (1,) * len(bs))
        yield ((d * d).sum(dim=0),                         # [nmax, nmax, *bs]
               valid_i[:, None] & valid_i[None, :] & not_self)
        # the float32 pass unwraps neighbors as the JAX package does; a float64
        # pass differences the stored coordinates with no float32 add
        nbr_pos, nbr_occ = cells.neighbor_stack(
            cfg, pos, occ, color, unwrap=dtype == torch.float32)
        valid_j = slot[None] < nbr_occ[:, None]            # [K, nmax, *bs]
        dx = min_image(own[None, :, :, None]
                       - nbr_pos[:, :dim].to(dtype)[:, :, None, :], box)
        yield ((dx * dx).sum(dim=1),                       # [K, nmax, nmax, *bs]
               valid_i[None, :, None] & valid_j[:, None, :])


def total_interaction_cells(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                            occ: torch.Tensor, dtype: torch.dtype = torch.float32
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total energy, any hard-core overlap) via cell lists.

    E = 1/2 sum_i sum_{j in ring(i), j != i} e_ij; O(N * 3^dim * nmax), so
    it runs at a million particles. In float32 this is the JAX package's
    computation; ``dtype=torch.float64`` differences the stored float32
    coordinates, evaluates the pair terms and sums in float64, so a total
    over a million particles is not limited by float32.
    """
    total = torch.zeros((), dtype=dtype, device=pos.device)
    any_ov = torch.zeros((), dtype=torch.bool, device=pos.device)
    for r2, valid in cell_pairs(cfg, pos, occ, dtype):
        e, ov = pair_interaction(pot, r2, valid)
        total = total + 0.5 * e.sum()
        any_ov = any_ov | ov.any()
    return total, any_ov


def total_energy_cells(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                       occ: torch.Tensor, dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Total energy via cell lists (``total_interaction_cells``, or
    ``mixture.total_interaction_cells_mixture`` for a mixture): the anchor
    that the summed dE of a run is held against."""
    if getattr(pot, "is_mixture", False):
        return mixture.total_interaction_cells_mixture(cfg, pot, pos, occ,
                                                       dtype)[0]
    return total_interaction_cells(cfg, pot, pos, occ, dtype)[0]


def min_pair_distance(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor
                      ) -> float:
    """Smallest distance between two live particles, via cell lists, with
    the stored float32 coordinates differenced in float64."""
    best = torch.tensor(float("inf"), dtype=torch.float64, device=pos.device)
    for r2, valid in cell_pairs(cfg, pos, occ, torch.float64):
        best = torch.minimum(best, torch.where(valid, r2, float("inf")).min())
    return float(best.sqrt())
