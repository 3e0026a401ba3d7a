"""The port's cell-list machinery held bit for bit against mcjax.ops.cells.

One jitted mcjax function computes every reference value (binning, unbinning,
the neighbor stacks of all four colors and the grid shift of the binned
state, with the shift axis and distance traced), so the whole file costs one
XLA compilation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.models.potentials import HardSphere as JaxHardSphere
from mcjax.ops import cells as jcells
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch.core.geometry import wrap_into_box as wrap
from mcjax_torch.ops import cells

N = 2048
# hard disks of diameter 1 at phi 0.5 in cells about two diameters wide, the
# geometry of bench.py
BOX = math.sqrt(N * math.pi / 4 / 0.5)
CPS = int(BOX // 2) - int(BOX // 2) % 2
KW = dict(dim=2, n_atoms=N, box_length=BOX,
          cells_per_side=CPS, nmax=7, n_moves=16, proposal="uniform",
          step_size=0.18, beta=1.0, seed=0)
JCFG = JaxConfig(**KW)
CFG = mt.SimConfig(**KW)


def _reference(positions, axis, d):
    pos, occ, ovf = jcells.bin_particles(JCFG, positions)
    flat = jcells.unbin(JCFG, pos, occ)
    nbrs = [jcells.neighbor_stack(JCFG, pos, occ, c) for c in range(4)]
    shifted = jcells.shift_rebin(JCFG, pos, occ, axis, d)
    totals = jsweep.total_interaction_cells(JCFG, JaxHardSphere(1.0), pos, occ)
    return (pos, occ, ovf), flat, nbrs, shifted, totals


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    fn = jax.jit(_reference)

    def run(positions, axis, d):
        out = fn(jnp.asarray(positions), jnp.int32(axis), jnp.float32(d))
        return jax.tree_util.tree_map(np.array, out)   # writable copies
    return run


def _positions(kind):
    if kind == "lattice":
        return cells.lattice_positions(CFG).numpy()
    rng = np.random.default_rng(7)
    half = CFG.box_length / 2
    if kind == "uniform":
        return rng.uniform(-half, half, (N, 2)).astype(np.float32)
    # "packed": every particle in a strip two cells wide, so cells overflow
    # at binning and the shift pushes full donors into full receivers.
    w = CFG.cell_width
    x = rng.uniform(-w, w, N)
    y = rng.uniform(-half, half, N)
    return np.stack([x, y], axis=1).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["uniform", "packed"])
def test_bin_unbin_bitwise(reference, kind):
    r = _positions(kind)
    (pos, occ, ovf), flat, *_ = reference(r, 0, 0.1)
    got_pos, got_occ, got_ovf = cells.bin_particles(CFG, torch.from_numpy(r))
    assert_bitwise(got_pos, pos)
    assert_bitwise(got_occ, occ)
    assert bool(got_ovf) == bool(ovf)
    if kind == "packed":
        assert bool(got_ovf)
    assert_bitwise(cells.unbin(CFG, got_pos, got_occ), flat)


@pytest.mark.parametrize("color", range(4))
def test_neighbor_stack_bitwise(reference, color):
    r = _positions("uniform")
    (pos, occ, _), _, nbrs, *_ = reference(r, 0, 0.1)
    got_pos, got_occ = cells.neighbor_stack(
        CFG, torch.from_numpy(pos), torch.from_numpy(occ), color)
    assert_bitwise(got_pos, nbrs[color][0])
    assert_bitwise(got_occ, nbrs[color][1])


@pytest.mark.parametrize("kind", ["uniform", "packed"])
@pytest.mark.parametrize("axis,sign", [(0, 1), (0, -1), (1, 1), (1, -1)])
def test_shift_rebin_bitwise(reference, kind, axis, sign):
    r = _positions(kind)
    d = np.float32(sign * 0.43 * CFG.cell_width)
    (pos, occ, _), _, _, (s_pos, s_occ, s_ovf), _ = reference(r, axis, d)
    got_pos, got_occ, got_ovf = mt.ops.cuda_shift.shift(
        CFG, torch.from_numpy(pos), torch.from_numpy(occ),
        torch.tensor(axis, dtype=torch.int32), torch.tensor(d))
    assert_bitwise(got_pos, s_pos)
    assert_bitwise(got_occ, s_occ)
    assert bool(got_ovf) == bool(s_ovf)
    if kind == "packed":
        assert bool(got_ovf)


@pytest.mark.parametrize("kind", ["uniform", "lattice"])
def test_total_interaction_cells_matches(reference, kind):
    """Hard-disk totals through the cell lists: zero energy, and an overlap
    exactly where mcjax finds one (random points overlap, the lattice does
    not)."""
    (pos, occ, _), _, _, _, (energy, overlap) = reference(_positions(kind),
                                                          0, 0.1)
    got_e, got_ov = mt.ops.sweep.total_interaction_cells(
        CFG, mt.HardSphere(1.0), torch.from_numpy(pos), torch.from_numpy(occ))
    assert float(got_e) == float(energy) == 0.0
    assert bool(got_ov) == bool(overlap) == (kind == "uniform")
    got_min = mt.ops.sweep.min_pair_distance(CFG, torch.from_numpy(pos),
                                             torch.from_numpy(occ))
    assert (got_min < 1.0) == (kind == "uniform")


def test_init_state_matches_lattice_binning(reference):
    lattice = np.asarray(jcells.lattice_positions(JCFG))
    np.testing.assert_array_equal(
        _bits(cells.lattice_positions(CFG).numpy()), _bits(lattice))
    (pos, occ, ovf), *_ = reference(lattice, 0, 0.1)
    st = mt.init_state(CFG, device="cpu")
    assert_bitwise(st.pos, pos)
    assert_bitwise(st.occ, occ)
    assert bool(st.overflow) == bool(ovf) is False
    assert st.sweep == 0


def test_state_numpy_round_trip(reference):
    (pos, occ, ovf), *_ = reference(_positions("packed"), 0, 0.1)
    st = mt.state_from_numpy(pos, occ, np.int32(5), ovf, device="cpu")
    assert st.pos.dtype == torch.float32 and st.occ.dtype == torch.int32
    back = mt.state_to_numpy(st)
    assert_bitwise(back[0], pos)
    assert_bitwise(back[1], occ)
    assert back[2] == 5 and bool(back[3]) == bool(ovf) is True
    # the tensors own their memory: writing one leaves the numpy data alone
    st.pos.zero_()
    assert np.any(pos != 0)


@pytest.mark.parametrize("axis,past", [(0, 0), (1, 1)])
def test_shift_keeps_seam_coordinates_on_their_side(axis, past):
    """A slot at y = +L/2 (past = 0 ulps) or an ulp beyond it (the top
    cell's float32 upper bound lies past L/2, so a move can put it there)
    stays in the top cell through a shift. The JAX package's wrap sends y to
    -L/2, the far side of the box, where neighbor reads unwrap it the wrong
    way and miss overlaps with it; the port keeps it at +L/2."""
    cfg = CFG.replace(n_atoms=1)
    h = np.float32(cfg.box_length / 2)
    y = np.float32(h)
    for _ in range(past):
        y = np.nextafter(y, np.float32(np.inf))
    # the reference rule: wrapping y lands on the far side
    assert float(wrap(torch.tensor(y), cfg.box_length)) < 0
    st = mt.zeros_state(cfg, device="cpu")
    top = cfg.half_cps - 1
    st.occ[2, 3, top] = 1                     # color 2: cell (6, cps - 1)
    st.pos[2, :, 0, 3, top] = torch.tensor([6.5 * cfg.cell_width - h, y])
    d = 0.3 if axis == 0 else float(np.spacing(h)) / 4
    pos, occ, ovf = mt.ops.cuda_shift.shift(
        cfg, st.pos, st.occ, torch.tensor(axis, dtype=torch.int32),
        torch.tensor(d, dtype=torch.float32))
    (c, b0, b1), = torch.nonzero(occ).tolist()
    assert b1 == top and (c >> 1) & 1 == 1    # still in the top row
    got_y = float(pos[c, 1, 0, b0, b1])
    assert abs(got_y - h) <= 2 * np.spacing(h)
    st2 = mt.SimState(pos=pos, occ=occ, sweep=1, overflow=ovf)
    mt.validate_state(cfg, st2, mt.HardSphere(1.0))
