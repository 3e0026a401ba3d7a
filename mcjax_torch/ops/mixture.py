"""Mixture sweep engine (twin of ``mcjax.ops.mixture``).

The species id rides the state as one extra plane: pos[color, dim + 1, ...],
plane ``dim`` holding the id as a float. Binning, the grid shift and the
neighbor reads move whole plane stacks with one slot selection, so an id
follows its particle through every re-bin. The sub-step slices the planes
apart only to evaluate energies, and never writes the species plane.

``color_substep_mixture`` is the plain version of the CUDA mixture sub-step
(``csrc/substep_mix.cu``, launched by ``cuda_substep.substep``); the totals
here are the energy anchor of a mixture run.
"""

from __future__ import annotations

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.geometry import min_image
from mcjax_torch.core.state import SimState
from mcjax_torch.ops import cells
from mcjax_torch.ops.cuda_substep import metropolis_moves, squared_norm


def init_mixture_state(cfg: SimConfig, positions: torch.Tensor,
                       species: torch.Tensor,
                       device: str | torch.device | None = None) -> SimState:
    """Bin [N, dim] positions and [N] integer species ids into a mixture
    state (pos carries dim + 1 planes; plane ``dim`` is the id). Runs on
    CUDA unless ``device`` names another device."""
    dev = resolve_device(device)
    spec = torch.as_tensor(species).to(device=dev, dtype=torch.float32)
    pos, occ, overflow = cells.bin_particles(
        cfg, torch.as_tensor(positions).to(dev), extra=spec[:, None])
    return SimState(pos=pos, occ=occ, sweep=0, overflow=overflow)


def unbin_mixture(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ([N, dim] positions, [N] int32 species)."""
    flat = cells.unbin(cfg, pos, occ)
    return flat[:, :cfg.dim], flat[:, cfg.dim].to(torch.int32)


def species_counts(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                   n_species: int) -> torch.Tensor:
    """Live particles of each species id 0..n_species-1 (int64 [S]), read
    on the state's device."""
    slot = torch.arange(cfg.nmax, device=pos.device).reshape(
        (1, cfg.nmax) + (1,) * cfg.dim)
    live = slot < occ[:, None]
    spec = pos[:, cfg.dim]
    return torch.stack([(live & (spec == float(s))).sum()
                        for s in range(n_species)])


def color_substep_mixture(cfg: SimConfig, pot, color: int, pos: torch.Tensor,
                          occ: torch.Tensor, pick_u: torch.Tensor,
                          disp: torch.Tensor, acc_u: torch.Tensor,
                          record: dict | None = None, *, scale=None,
                          field=None, origin=None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``cuda_substep.color_substep`` with species-resolved pair terms.

    pos holds dim + 1 planes; the mover's species is read from its slot and
    each pair term is ``pot.pair_energy_s(r2, s_mover, s_other)``. The
    species plane is frozen during the moves and re-attached on return.
    ``record`` receives the per-cell maps of ``color_substep`` (``de_cell``,
    ``in_cell``, ``margin``). The JAX package's NPT ``scale`` and external
    ``field`` / ``origin`` terms are not ported; passing one raises.

    Returns (new own-color block [dim + 1, nmax, *bs], dE, accepted,
    proposed) as ``color_substep`` does.
    """
    if scale is not None or field is not None or origin is not None:
        raise NotImplementedError(
            "the NPT scale and external-field forms of the mixture sub-step "
            "are not ported")
    dim = cfg.dim
    own = pos[color]                                   # [dim+1, nmax, *bs]
    ownp, ownspec = own[:dim], own[dim]
    own_occ = occ[color]
    nbr_all, nbr_occ = cells.neighbor_stack(cfg, pos, occ, color)
    nbrp, nbrspec = nbr_all[:, :dim], nbr_all[:, dim]  # [K, dim|-, nmax, *bs]
    slot = torch.arange(cfg.nmax, device=pos.device).reshape(
        (cfg.nmax,) + (1,) * dim)
    nbr_valid = slot[None] < nbr_occ[:, None]          # [K, nmax, *bs]

    def energy_at(x, ownp_cur, valid_own, sel):
        """(energy, overlap) of the mover, of the species in its slot, at
        x [dim, *bs] against its own cell's valid slots and the frozen
        neighbor slots."""
        sx = torch.where(sel, ownspec, 0.0).sum(dim=0)             # [*bs]
        r2_own = squared_norm(x[:, None] - ownp_cur, 0)            # [nmax, *bs]
        e_o = torch.where(valid_own,
                          pot.pair_energy_s(r2_own, sx[None], ownspec), 0.0)
        r2_nbr = squared_norm(x[None, :, None] - nbrp, 1)      # [K, nmax, *bs]
        e_n = torch.where(nbr_valid, pot.pair_energy_s(r2_nbr, sx[None, None],
                                                       nbrspec), 0.0)
        ov = torch.zeros_like(sx, dtype=torch.bool)
        if pot.has_hard_core:
            ov = ((valid_own & pot.overlap_s(r2_own, sx[None], ownspec)).any(0)
                  | (nbr_valid & pot.overlap_s(r2_nbr, sx[None, None],
                                               nbrspec)).any(1).any(0))
        return e_o.sum(dim=0) + e_n.sum(dim=(0, 1)), ov

    ownp_new, de, n_acc, n_prop = metropolis_moves(
        cfg, color, ownp, own_occ, pick_u, disp, acc_u, energy_at, True,
        record)
    return torch.cat([ownp_new, ownspec[None]], dim=0), de, n_acc, n_prop


def _species_blocks(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                    dtype: torch.dtype):
    """The (s_i, s_j) operands matching ``sweep.cell_pairs``' blocks."""
    dim = cfg.dim
    for color in range(cfg.n_colors):
        s_own = pos[color, dim].to(dtype)                  # [nmax, *bs]
        yield s_own[:, None], s_own[None, :]
        nbr, _ = cells.neighbor_stack(cfg, pos, occ, color, unwrap=False)
        yield s_own[None, :, None], nbr[:, dim].to(dtype)[:, None, :]


def total_interaction_cells_mixture(cfg: SimConfig, pot, pos: torch.Tensor,
                                    occ: torch.Tensor,
                                    dtype: torch.dtype = torch.float32
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total energy, any overlap) of a mixture state via cell lists: the
    anchor the summed dE of a run is held against.

    In float32 this is the JAX package's computation term by term (the sum
    runs in PyTorch's order, not XLA's); ``dtype=torch.float64``
    differences the stored float32 coordinates, evaluates the pair terms
    and sums in float64.
    """
    from mcjax_torch.ops.sweep import cell_pairs

    total = torch.zeros((), dtype=dtype, device=pos.device)
    any_ov = torch.zeros((), dtype=torch.bool, device=pos.device)
    for (r2, valid), (si, sj) in zip(
            cell_pairs(cfg, pos, occ, dtype),
            _species_blocks(cfg, pos, occ, dtype)):
        e = torch.where(valid, pot.pair_energy_s(r2, si, sj), 0.0)
        total = total + 0.5 * e.sum()
        any_ov = any_ov | (valid & pot.overlap_s(r2, si, sj)).any()
    return total, any_ov


def total_energy_mixture_n2(pot, positions: torch.Tensor,
                            species: torch.Tensor, box_length: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """O(N^2) species-resolved reference energy (a test oracle for small
    N), in the dtype of ``positions``."""
    r = torch.as_tensor(positions)
    s = torch.as_tensor(species).to(r.dtype)
    d = min_image(r[:, None, :] - r[None, :, :], box_length)
    r2 = (d * d).sum(dim=-1)
    off = ~torch.eye(r.shape[0], dtype=torch.bool, device=r.device)
    e = torch.where(off, pot.pair_energy_s(r2, s[:, None], s[None, :]), 0.0)
    ov = off & pot.overlap_s(r2, s[:, None], s[None, :])
    return 0.5 * e.sum(), ov.any()
