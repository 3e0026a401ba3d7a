"""External-field runs: frame bookkeeping and drivers (twin of
``mcjax.ops.extfield``).

The sweep's random grid shift re-expresses every stored coordinate in a
drifting frame (shifting the cell grid by +d subtracts d from every
coordinate, ``cells._shift_rebin_axis``), which a translation-invariant
bulk never notices, but a one-body field lives at ABSOLUTE positions.
These drivers carry the cumulative frame ``origin``: physical
x = wrap(stored + origin), updated in lockstep with each sweep's own shift
draws (``field_sweep``), on the device, with no host sync.

The field's dE folds into the Metropolis test inside the sub-steps (the
plain versions and the kernels' field forms, ``cuda_substep``), so the
energy anchor extends: summed dE == change of (pair total + field total).

Not ported: the JAX package's ``replay_origin``, which rebuilds the origin
of a finished run from its key alone. The port's ``TorchRandoms`` draws in
call order, not from a (key, sweep) tree, so no replay can be exact yet.
"""

from __future__ import annotations

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.geometry import wrap_into_box
from mcjax_torch.core.state import SimState
from mcjax_torch.models import fields
from mcjax_torch.models.potentials import Potential
from mcjax_torch.ops import cells
from mcjax_torch.ops.random import RandomProvider
from mcjax_torch.ops.sweep import SweepMetrics, sweep_with_schedule


def physical_positions(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                       origin: torch.Tensor, n_out: int | None = None
                       ) -> torch.Tensor:
    """Unbin to [n_out, planes] ABSOLUTE coordinates (stored + origin,
    wrapped); a mixture's species column comes back untouched."""
    r = cells.unbin(cfg, pos, occ, n_out=n_out)
    coords = wrap_into_box(r[:, :cfg.dim] + origin[None, :], cfg.box_length)
    if r.shape[1] > cfg.dim:
        return torch.cat([coords, r[:, cfg.dim:]], dim=1)
    return coords


def _physical_planes(cfg: SimConfig, pos: torch.Tensor, origin: torch.Tensor,
                     color: int
                     ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(physical coordinates [dim, nmax, *bs], species plane or None) of
    one color block, in float32 as the sub-steps see them."""
    dim = cfg.dim
    own = pos[color]
    px = wrap_into_box(
        own[:dim] + origin.reshape((dim,) + (1,) * (own.ndim - 1)),
        cfg.box_length)
    spec = own[dim] if own.shape[0] > dim else None
    return px, spec


def _live(cfg: SimConfig, occ: torch.Tensor, color: int) -> torch.Tensor:
    own_occ = occ[color]
    slot = torch.arange(cfg.nmax, device=occ.device).reshape(
        (cfg.nmax,) + (1,) * own_occ.ndim)
    return slot < own_occ[None]


def total_field_energy_cells(cfg: SimConfig, field, pos: torch.Tensor,
                             occ: torch.Tensor, origin: torch.Tensor,
                             dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Sum of the one-body field energy over all live particles
    (species-resolved for a mixture state). In float32 this is the JAX
    package's computation term by term (summed in PyTorch's order);
    ``dtype=torch.float64`` evaluates the field at the float32 physical
    coordinates the sub-steps use, with float64 constants, and sums in
    float64, so a total over a million particles is not limited by
    float32."""
    e = torch.zeros((), dtype=dtype, device=pos.device)
    for color in range(cfg.n_colors):
        px, spec = _physical_planes(cfg, pos, origin, color)
        spec = None if spec is None else spec.to(dtype)
        u = fields.species_energy(field, px.to(dtype), spec)
        e = e + (_live(cfg, occ, color).to(dtype) * u).sum()
    return e


def field_violations(cfg: SimConfig, field, pos: torch.Tensor,
                     occ: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Number of live particles inside the field's forbidden region (int64
    0-d; stays 0 through a run that started valid)."""
    n = torch.zeros((), dtype=torch.int64, device=pos.device)
    for color in range(cfg.n_colors):
        px, spec = _physical_planes(cfg, pos, origin, color)
        bad = fields.species_forbidden(field, px, spec)
        n = n + (_live(cfg, occ, color) & bad).sum()
    return n


def field_sweep(cfg: SimConfig, pot: Potential, field, state: SimState,
                origin: torch.Tensor, randoms: RandomProvider
                ) -> tuple[SimState, torch.Tensor, SweepMetrics]:
    """One sweep under ``field``; returns the advanced frame origin.

    The grid shift subtracts d from the stored ``axis`` coordinates, so the
    origin gains +d on that axis: origin <- wrap(origin + step * [a ==
    axis]), step = d on a shift sweep and 0 otherwise, as
    ``mcjax.ops.extfield.field_sweep`` computes it, from the sweep's own
    shift draws (device tensors). Consumes ``state`` (see ``mc_sweep``).
    """
    do_shift = (state.sweep + 1) % cfg.shift_every == 0
    new_state, m, (axis, d) = sweep_with_schedule(
        cfg, pot, state, randoms, field=field, origin=origin)
    step = d if do_shift else torch.zeros_like(d)
    onehot = (torch.arange(cfg.dim, device=origin.device) == axis).to(
        torch.float32)
    origin = wrap_into_box(origin + step * onehot, cfg.box_length)
    return new_state, origin, m


def run_field_sweeps(cfg: SimConfig, pot: Potential, field, state: SimState,
                     origin: torch.Tensor, n_sweeps: int,
                     randoms: RandomProvider
                     ) -> tuple[SimState, torch.Tensor, SweepMetrics]:
    """``n_sweeps`` field sweeps; per-sweep metrics stacked ([n_sweeps]
    each). The metric's delta_e includes the field's dE, so its sum anchors
    against the change of ``total_energy_cells`` +
    ``total_field_energy_cells``. Consumes ``state``."""
    ms = []
    for _ in range(n_sweeps):
        state, origin, m = field_sweep(cfg, pot, field, state, origin,
                                       randoms)
        ms.append(m)
    return (state, origin,
            SweepMetrics(*(torch.stack(f) for f in zip(*ms))))


def run_field_sweeps_record(cfg: SimConfig, pot: Potential, field,
                            state: SimState, origin: torch.Tensor,
                            n_frames: int, sweeps_per_frame: int,
                            randoms: RandomProvider
                            ) -> tuple[SimState, torch.Tensor, torch.Tensor,
                                       SweepMetrics]:
    """Frame-recording variant: the [n_frames, n_atoms, planes] PHYSICAL
    trajectory, one frame after every ``sweeps_per_frame`` sweeps, with
    each frame's metrics summed (overflow: any)."""
    frames, aggs = [], []
    for _ in range(n_frames):
        state, origin, ms = run_field_sweeps(cfg, pot, field, state, origin,
                                             sweeps_per_frame, randoms)
        frames.append(physical_positions(cfg, state.pos, state.occ, origin))
        aggs.append(SweepMetrics(ms.delta_e.sum(), ms.accepted.sum(),
                                 ms.proposed.sum(), ms.overflow.any()))
    return (state, origin, torch.stack(frames),
            SweepMetrics(*(torch.stack(f) for f in zip(*aggs))))
