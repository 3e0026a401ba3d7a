"""The sub-step kernels' frozen-slot culling against mcjax's pair energies
and hard-disk overlaps.

``cuda_substep.keep_frozen`` is the float32 twin of the box-distance test
that ``csrc/substep_lj.cu`` and ``csrc/substep_mix.cu`` apply when they
stage a cell's frozen neighbor slots, and ``csrc/substep.cu`` with the
diameter in place of the cutoff. A slot the test drops is never
evaluated, so the test must keep every slot whose pair term is non-zero
for some position a mover can hold: any point of the own cell, or an own
slot a few float32 ulps of L/2 outside it after a grid shift. Here slots
sit 1-4 float32 ulps inside and outside the largest cutoff from the points
of the cell nearest to them (its faces, edges and corners, and points 4
ulps beyond them), and mcjax's own ``pair_energy`` / ``pair_energy_s``
(float32, on the CPU) decides which terms are non-zero. The kernels
themselves are held to these placements on the card in
``tests/test_torch_cuda.py::test_energetic_kernels_at_the_cutoff_edge``
and ``test_disk_kernel_at_the_cull_edge``. For hard disks mcjax's own
``HardSphere.overlap`` decides which slots count.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.models.mixtures import kob_andersen as jax_kob_andersen
from mcjax.models.potentials import HardSphere as JaxHardSphere
from mcjax.models.potentials import LennardJones as JaxLennardJones

import mcjax_torch as mt
from mcjax_torch.ops import cuda_substep

# The 1M lj3d and ka3d geometries (``mcjax_torch.bench``): box and cells.
GEOMETRY = {"lj3d": ((1e6 / 0.8) ** (1 / 3), 42),
            "ka3d": ((1e6 / 1.2) ** (1 / 3), 36)}
# The 1M hard-disk geometry (``mcjax_torch.bench.build`` at its defaults).
DISKS = (math.sqrt((1 << 20) * math.pi / 4 / 0.5), 640)
ULPS = (-4, -3, -2, -1, 1, 2, 3, 4)


def _cfg(workload):
    box, cps = GEOMETRY[workload]
    return mt.SimConfig(dim=3, n_atoms=1, box_length=box, cells_per_side=cps,
                        nmax=8, n_moves=1)


def _step(x: np.float32, ulps: int) -> np.float32:
    """x moved by ``ulps`` float32 steps."""
    to = np.float32(math.copysign(np.inf, ulps))
    for _ in range(abs(ulps)):
        x = np.nextafter(x, to)
    return x


def _placements(cfg, color, block, r_cut):
    """(mover, slot) float32 pairs [n, dim] each: for every one of the
    3^dim - 1 directions to a neighbor cell, the point of the own cell
    nearest that neighbor (on the cell's bound, or 4 ulps beyond it on the
    axes it faces) and a slot at r_cut from it along the direction, moved 1-4
    float32 ulps in and out on each axis it faces. Also returns the cell's
    lower corner as ``cell_lower_bounds`` computes it."""
    dim = cfg.dim
    # a grid just large enough to hold ``block`` (a bound depends only on
    # the block index and the color)
    lower = cuda_substep.cell_lower_bounds(cfg, color,
                                           tuple(b + 1 for b in block),
                                           torch.device("cpu"))
    lb = lower[(slice(None), *block)].numpy()
    hi = (lower[(slice(None), *block)]
          + torch.tensor(cfg.cell_width, dtype=torch.float32)).numpy()
    movers, slots = [], []
    dirs = [d for d in itertools.product((-1, 0, 1), repeat=dim) if any(d)]
    for d, outside, ulps in itertools.product(dirs, (0, 4), ULPS):
        norm = math.sqrt(sum(v * v for v in d))
        x = np.empty(dim, np.float32)
        y = np.empty(dim, np.float32)
        for a in range(dim):
            if d[a] < 0:
                x[a] = _step(lb[a], -outside)
            elif d[a] > 0:
                x[a] = _step(_step(hi[a], -1), outside)
            else:
                x[a] = np.float32(lb[a] + cfg.cell_width / 2)
            y[a] = np.float32(float(x[a]) + r_cut * d[a] / norm)
            if d[a]:
                y[a] = _step(y[a], ulps * d[a])
        movers.append(x)
        slots.append(y)
    return np.stack(movers), np.stack(slots), lower[(slice(None), *block)]


_r2 = jax.jit(lambda x, y: jnp.sum((x - y) * (x - y), axis=-1))


@pytest.mark.parametrize("workload", ["lj3d", "ka3d"])
def test_culling_keeps_every_slot_mcjax_counts(workload):
    """Every slot with a non-zero mcjax pair term from a mover position is
    kept; slots 1e-3 beyond the cutoff (four times the margins) are
    dropped, so the test is not vacuous."""
    cfg = _cfg(workload)
    if workload == "lj3d":
        pot = JaxLennardJones(r_cut=2.5)
        r_cut = pot.r_cut

        def energies(r2):
            return [np.asarray(pot.pair_energy(r2))]
    else:
        pot = jax_kob_andersen(shift=False)
        r_cut = max(max(row) for row in pot.r_cut_table)

        def energies(r2):
            return [np.asarray(pot.pair_energy_s(
                r2, jnp.full(r2.shape, si), jnp.full(r2.shape, sj)))
                for si in (0, 1) for sj in (0, 1)]
    top = cfg.half_cps - 1
    counted = 0
    for color, block in ((0, (3, 4, 5)), (7, (top, top, top)),
                         (5, (0, top, 0))):
        x, y, lower = _placements(cfg, color, block, r_cut)
        r2 = _r2(jnp.asarray(x), jnp.asarray(y))
        nonzero = np.any([e != 0 for e in energies(r2)], axis=0)
        keep = cuda_substep.keep_frozen(cfg, r_cut, lower,
                                        torch.from_numpy(y)).numpy()
        assert not np.any(nonzero & ~keep)
        counted += int(nonzero.sum())
        # Slots well past the cutoff from the nearest point are dropped.
        unit = (y - x) / np.linalg.norm(y - x, axis=-1, keepdims=True)
        far = (x + unit * np.float32(r_cut + 1e-3)).astype(np.float32)
        inside = np.all((x >= lower.numpy())
                        & (x < lower.numpy() + cfg.cell_width), axis=-1)
        assert not cuda_substep.keep_frozen(
            cfg, r_cut, lower, torch.from_numpy(far[inside])).any()
    assert counted > 0


def test_disk_culling_keeps_every_slot_mcjax_overlaps():
    """2D hard disks at the 1M geometry, the diameter in place of the
    cutoff: every slot that mcjax's hard-disk overlap counts from a mover
    position is kept; slots 1e-3 past the diameter from the cell grown by
    the pad are dropped (at L/2 = 641.7 the pad, 1e-5 + 64 ulps of L/2, is
    3.9e-3, so it is added to the distance)."""
    box, cps = DISKS
    cfg = mt.SimConfig(dim=2, n_atoms=1, box_length=box, cells_per_side=cps,
                       nmax=7, n_moves=1)
    dia = 1.0
    pad, _ = cuda_substep.cull_constants(cfg, dia)
    top = cfg.half_cps - 1
    counted = 0
    for color, block in ((0, (3, 4)), (3, (top, top)), (1, (0, top))):
        x, y, lower = _placements(cfg, color, block, dia)
        # r2 as XLA on the CPU computes jnp.sum(d * d) in 2D, through the
        # port's twin (held to XLA by test_torch_sweep.py::
        # test_contraction_sites_match_xla), so nothing compiles here
        r2 = cuda_substep.squared_norm(torch.from_numpy(x - y), -1).numpy()
        overlap = np.asarray(JaxHardSphere(dia).overlap(r2))
        keep = cuda_substep.keep_frozen(cfg, dia, lower,
                                        torch.from_numpy(y)).numpy()
        assert not np.any(overlap & ~keep)
        counted += int(overlap.sum())
        unit = (y - x) / np.linalg.norm(y - x, axis=-1, keepdims=True)
        far = (x + unit * np.float32(dia + 1e-3 + 2 * pad)).astype(
            np.float32)
        inside = np.all((x >= lower.numpy())
                        & (x < lower.numpy() + cfg.cell_width), axis=-1)
        assert not cuda_substep.keep_frozen(
            cfg, dia, lower, torch.from_numpy(far[inside])).any()
    assert counted > 0


def test_cull_constants_cover_validate_state():
    """The pad covers an own slot as far outside its cell as
    ``validate_state`` allows (1e-5 + 4 float32 ulps of L/2) with room to
    spare, and the reach exceeds the cutoff by the relative margin."""
    for workload in GEOMETRY:
        cfg = _cfg(workload)
        pad, reach2 = cuda_substep.cull_constants(cfg, 2.5)
        ulp = float(np.spacing(np.float32(cfg.box_length / 2)))
        assert pad >= 1e-5 + 16 * ulp
        assert math.sqrt(reach2) == pytest.approx(
            2.5 * (1 + cuda_substep.CULL_REL), rel=1e-12)
