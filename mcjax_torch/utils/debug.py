"""State invariant checking (twin of ``mcjax.utils.debug.validate_state``).

The checks run as tensor operations on the state's device and read a
handful of scalars at the end, so they are cheap at a million particles;
the hard-core overlap check goes through the cell lists
(``total_interaction_cells``), not the O(N^2) oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.state import SimState
from mcjax_torch.models.potentials import Potential
from mcjax_torch.ops import cells


class StateInvariantError(AssertionError):
    pass


def validate_state(cfg: SimConfig, state: SimState,
                   pot: Potential | None = None,
                   expect_atoms: int | None = None,
                   expect_species: list[int] | None = None
                   ) -> dict[str, float]:
    """Check every structural invariant of a SimState; raise on violation.

    1. occupancy in [0, nmax] and the total matches n_atoms;
    2. the sticky overflow flag is unset;
    3. every live slot lies inside its cell's exact bounds, up to a slack;
    4. coordinates are inside the box, up to the same slack;
    5. (optional, hard-core models) no two particles closer than the
       diameter, up to a slack;
    6. (mixture states, whose pos carries a species plane after the dim
       coordinate planes) every live species id is an integer in [0, S),
       S from a mixture ``pot`` or from ``expect_species``, and, when
       ``expect_species`` gives the population of each id, the counts match
       it.

    Checks 3 and 4 read the coordinate planes only.

    The slacks are set by float32 resolution, which at a million particles
    is coarse: coordinates are box-frame float32 in [-L/2, L/2), and at
    N = 2^20 (L/2 = 641.7) one ulp is 6.1e-5.
      * Cell bounds: the sweep's cell edges are float32 values
        (fma(c, w, -L/2) with w and L/2 rounded) and the grid shift bins
        with a float32 reciprocal; both sets of edges lie within 2 ulps of
        the exact edges c*w - L/2, so the slack is the JAX package's 1e-5
        plus 4 ulps of L/2.
      * Contact: the sweep decides overlaps in float32 on unwrapped
        neighbors, and every grid shift re-rounds each coordinate
        (x - d, then the periodic wrap), so a pair accepted just outside
        contact can end a few ulps inside it. The distance is measured in
        float64 on the stored coordinates; the slack is 16 ulps of L/2.
    A violation of real physics (a missed neighbor, a wrong unwrap) is a
    fraction of the step size, orders of magnitude beyond either slack.

    Returns the worst slot outside its exact cell and the deepest
    overlap, each in float32 ulps of L/2 (0.0 when there is none).
    """
    from mcjax_torch.ops.sweep import min_pair_distance

    occ, pos = state.occ, state.pos
    n_expected = expect_atoms if expect_atoms is not None else cfg.n_atoms
    occ_min, occ_max, total = (int(v) for v in
                               (occ.min(), occ.max(), occ.sum(dtype=torch.int64)))
    if occ_min < 0 or occ_max > cfg.nmax:
        raise StateInvariantError(f"occupancy out of range [0,{cfg.nmax}]: "
                                  f"min={occ_min} max={occ_max}")
    if total != n_expected:
        raise StateInvariantError(
            f"particle count {total} != expected {n_expected}")
    if bool(state.overflow):
        raise StateInvariantError("sticky capacity-overflow flag is set")

    w = cfg.cell_width
    half_l = cfg.box_length / 2.0
    ulp = float(np.spacing(np.float32(half_l)))
    slack = 1e-5 + 4 * ulp
    excursion = 0.0
    bs = cfg.block_shape
    slot = torch.arange(cfg.nmax, device=pos.device).reshape(
        (cfg.nmax,) + (1,) * cfg.dim)
    for color in range(cfg.n_colors):
        o = cells.color_bits(color, cfg.dim)
        valid = slot < occ[color][None]                     # [nmax, *bs]
        for k in range(cfg.dim):
            ck = 2 * cells.block_index(bs, k, pos.device).double() + o[k]
            lo = (ck * w - half_l)[None]
            x = pos[color, k].double()                      # [nmax, *bs]
            if bool((valid & (x.abs() > half_l + slack)).any()):
                raise StateInvariantError("coordinates outside the box")
            outside = torch.where(valid, torch.clamp(
                torch.maximum(lo - x, x - (lo + w)), min=0.0), 0.0)
            excursion = max(excursion, float(outside.max()) / ulp)
            bad = valid & ((x < lo - slack) | (x >= lo + w + slack))
            n_bad = int(bad.sum())
            if n_bad:
                raise StateInvariantError(
                    f"color {color}: {n_bad} slab entries outside their "
                    f"cell bounds along axis {k} (worst {excursion:.2f} "
                    f"ulps of L/2 = {ulp:.3g})")

    if pos.shape[1] > cfg.dim:
        _check_species(cfg, pos, occ, pot, expect_species)

    depth = 0.0
    if pot is not None and pot.has_hard_core:
        depth = max(0.0, pot.r_cut - min_pair_distance(cfg, pos, occ)) / ulp
        if depth > 16:
            raise StateInvariantError(
                f"hard-core overlap {depth:.2f} ulps of L/2 = {ulp:.3g} deep")
    return {"cell_excursion_ulps": excursion, "overlap_depth_ulps": depth}


def _check_species(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                   pot: Potential | None,
                   expect_species: list[int] | None) -> None:
    """Check 6 of ``validate_state``."""
    from mcjax_torch.ops.mixture import species_counts

    if pot is not None and getattr(pot, "is_mixture", False):
        n_species = pot.n_species
    elif expect_species is not None:
        n_species = len(expect_species)
    else:
        raise ValueError("a mixture state needs a mixture pot or "
                         "expect_species to be checked")
    slot = torch.arange(cfg.nmax, device=pos.device).reshape(
        (1, cfg.nmax) + (1,) * cfg.dim)
    spec = pos[:, cfg.dim][slot < occ[:, None]]
    n_bad = int(((spec != torch.round(spec)) | (spec < 0)
                 | (spec >= n_species)).sum())
    if n_bad:
        raise StateInvariantError(f"{n_bad} live species ids are not "
                                  f"integers in [0, {n_species})")
    if expect_species is not None:
        got = species_counts(cfg, pos, occ, n_species).tolist()
        if got != list(expect_species):
            raise StateInvariantError(f"species populations {got} != "
                                      f"expected {list(expect_species)}")
