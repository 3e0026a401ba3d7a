"""NPT (isothermal-isobaric) ensemble: ln-V volume moves on top of the sweep
(twin of ``mcjax.ops.npt``).

Stored-frame convention, as in the JAX package: ``cfg.box_length`` is the
reference box L0 and never changes, and so do the cells, the binning and
the grid shift. The state carries ``log_scale``; the physical box is s L0
and physical coordinates are s times the stored ones, so a volume move
changes nothing but the pair distances, r^2 = s^2 r~^2 (the ``scale`` of
``mc_sweep`` and of the cell-list totals). On CUDA the sub-steps run the
NPT forms of the hand-written kernels, which read s^2 from device memory.

A volume move (Frenkel & Smit, alg. 11) proposes dlnV ~ U(-delta, delta)
and accepts with min(1, exp(-beta dU - beta P dV + (N+1) dlnV)); a hard-core
overlap at the new scale, or a physical cell width below the cutoff (the
one-ring contract), rejects outright. Its draws come from the provider's
``volume`` stream, apart from the particle draws. The move stays on the
device: the new total is a plain PyTorch cell-list pass (the JAX package
computes it in XLA, outside any TPU kernel), the decision a
``torch.where``, so an NPT sweep makes no host sync, like the NVT sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.state import SimState
from mcjax_torch.models.potentials import Potential
from mcjax_torch.ops.random import RandomProvider
from mcjax_torch.ops.sweep import SweepMetrics, mc_sweep, total_interaction

# Called inside a volume move with (cfg, pot, pos, occ, s, s_new, u_cur,
# u_new): the system, the state, the current and proposed scales and the
# float32 energies the decision uses. For measurements only; nothing of the
# chain reads it.
VolumeHook = Callable[[SimConfig, Potential, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                      None]


@dataclasses.dataclass
class NPTState:
    """An NVT SimState and the box scale as log s (float32 0-d, on the
    state's device)."""

    sim: SimState
    log_scale: torch.Tensor

    @property
    def scale(self) -> torch.Tensor:
        return torch.exp(self.log_scale)


class NPTMetrics(NamedTuple):
    sweep: SweepMetrics         # particle-move metrics
    vol_accepted: torch.Tensor  # volume move accepted this sweep (bool)
    volume: torch.Tensor        # physical volume after the move (float32)
    energy: torch.Tensor        # total energy after the move (float32)


def init_npt(state: SimState) -> NPTState:
    return NPTState(sim=state, log_scale=torch.zeros(
        (), dtype=torch.float32, device=state.pos.device))


def box_volume(cfg: SimConfig, scale: torch.Tensor) -> torch.Tensor:
    """(s L0)^dim in float32, as the JAX package's ``(s * l0) ** dim``."""
    side = scale * cfg.box_length
    vol = side * side
    return vol * side if cfg.dim == 3 else vol


def npt_sweep(cfg: SimConfig, pot: Potential, nst: NPTState,
              randoms: RandomProvider, pressure: float, u_old: torch.Tensor,
              dlnv_max: float = 0.02, do_volume: bool = True,
              volume_hook: VolumeHook | None = None
              ) -> tuple[NPTState, NPTMetrics]:
    """One NPT sweep: a particle sweep at the current scale, then one ln-V
    volume move (skipped when ``do_volume`` is False, a schedule the host
    knows).

    ``u_old`` is the carried total energy at the current scale; the sweep's
    summed dE updates it, so a volume move costs one cell-list pass (at the
    proposed scale). Consumes ``nst.sim`` (see ``mc_sweep``).
    """
    beta, dim, n = cfg.beta, cfg.dim, cfg.n_atoms
    s = torch.exp(nst.log_scale)
    sim, m = mc_sweep(cfg, pot, nst.sim, randoms, scale=s)
    u_cur = u_old + m.delta_e

    log_scale, energy = nst.log_scale, u_cur
    accepted = torch.zeros((), dtype=torch.bool, device=s.device)
    if do_volume:
        dlnv, u = randoms.volume(cfg, sim.sweep, dlnv_max)
        s_new = s * torch.exp(dlnv / dim)
        u_new, ov_new = total_interaction(cfg, pot, sim.pos, sim.occ,
                                          scale=s_new)
        if volume_hook is not None:
            volume_hook(cfg, pot, sim.pos, sim.occ, s, s_new, u_cur, u_new)
        v_old = box_volume(cfg, s)
        v_new = box_volume(cfg, s_new)
        ln_acc = (-beta * (u_new - u_cur)
                  - beta * pressure * (v_new - v_old) + (n + 1) * dlnv)
        # one-ring contract: the physical cell width stays >= the cutoff
        ok_geom = s_new * cfg.cell_width >= pot.r_cut
        accepted = ok_geom & ~ov_new & (torch.log(u) < ln_acc)
        log_scale = torch.where(accepted, nst.log_scale + dlnv / dim,
                                nst.log_scale)
        energy = torch.where(accepted, u_new, u_cur)
    metrics = NPTMetrics(sweep=m, vol_accepted=accepted,
                         volume=box_volume(cfg, torch.exp(log_scale)),
                         energy=energy)
    return NPTState(sim=sim, log_scale=log_scale), metrics


def run_npt(cfg: SimConfig, pot: Potential, nst: NPTState, pressure: float,
            n_sweeps: int, randoms: RandomProvider, dlnv_max: float = 0.02,
            volume_every: int = 1, anchor_every: int = 0,
            volume_hook: VolumeHook | None = None,
            u0: torch.Tensor | None = None
            ) -> tuple[NPTState, NPTMetrics]:
    """``n_sweeps`` NPT sweeps; metrics stacked per sweep.

    The total energy is anchored once, by a cell-list pass at the start,
    then carried by each sweep's summed dE and the accepted volume moves;
    ``u0``, the energy a previous run carried to ``nst`` (its last
    ``energy``), continues that run's instead of a new anchor.
    ``volume_every=k`` attempts the volume move after every k-th sweep
    (sweep counts s with (s + 1) % k == 0); ``anchor_every=k`` re-anchors
    the carried energy exactly before each sweep whose count is a multiple
    of k (0: only the first anchor). Consumes ``nst.sim``.
    """
    u = u0 if u0 is not None else total_interaction(
        cfg, pot, nst.sim.pos, nst.sim.occ, scale=nst.scale)[0]
    ms = []
    for _ in range(n_sweeps):
        if anchor_every and nst.sim.sweep % anchor_every == 0:
            u = total_interaction(cfg, pot, nst.sim.pos, nst.sim.occ,
                                  scale=nst.scale)[0]
        do_volume = (nst.sim.sweep + 1) % volume_every == 0
        nst, m = npt_sweep(cfg, pot, nst, randoms, pressure, u, dlnv_max,
                           do_volume, volume_hook)
        u = m.energy
        ms.append(m)
    sweeps = SweepMetrics(*(torch.stack(f) for f in zip(*(m.sweep
                                                          for m in ms))))
    stacked = NPTMetrics(sweeps, *(torch.stack(f)
                                   for f in zip(*(m[1:] for m in ms))))
    return nst, stacked
