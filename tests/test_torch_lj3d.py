"""3D Lennard-Jones: the port's plain path held against mcjax.ops.sweep.

The configuration is 3D LJ (r_cut 2.5) with 500 atoms in a box of 10 cut
into 4^3 cells, nmax 24, n_moves 3, gaussian step 0.2, beta 0.5, started
from mcjax's stratified positions (the size of tests/test_pallas_fused.py's
LJ lock).

The reference run is mcjax's ``mc_sweep`` (``run_sweeps`` is a scan of it),
jitted once and called once per sweep, with its color sub-steps
(``mcjax.ops.sweep.color_substep``) compiled as ``run_sweeps`` compiles
them. A ``substep_fn`` wrapper reports each sub-step's input state, output
and random draws through ``jax.debug.callback``. Each grid shift
(``mcjax.ops.cells.shift_rebin``) runs op by op between the calls: compiled
for 3D it alone costs some 20 s of XLA time here, and op by op it gives the
same bits (it has no contraction site; ``scripts/check_torch_lj3d_reference.py``
holds the port's run against jitted ``run_sweeps``). The port is fed the
same random numbers.

Gates, with their tolerances:
* positions, occupancies, accept and propose counts and the overflow flag
  equal bit for bit, except in cells where an accept decision may differ:
  a cell where some move had |acc_u - a| <= NEAR_TIE * a, a = exp(-beta dE),
  since the port sums dE in another order than XLA (the count of such cells
  is reported, and no other cell may differ);
* per-sub-step and per-sweep dE within DE_REL relative plus DE_ABS absolute;
* a plain run's summed dE, plus the energy changes of its grid shifts,
  equals the float64 energy difference within ANCHOR_REL (mcjax's gate,
  tests/test_pallas_frozen.py; see test_energy_anchor for the shifts).

The plain sub-step is held against the TPU kernels K4
(``pallas_sweep.pallas_color_substep``) and K5 (``pallas_sweep._fused_core``)
through mcjax's own locks, which tie them to the XLA ``color_substep`` held
here: tests/test_pallas.py::test_pallas_lj_3d_matches_xla (K4 against XLA),
tests/test_pallas_fused.py::test_fused_bitwise_lj3d (K5 = K4 bit for bit, at
this size) and tests/test_pallas_frozen.py (K5's frozen cache, by its dE
anchor). Run here in interpret mode, K5 costs 16 s of compilation a color;
scripts/check_torch_lj3d_reference.py holds the plain sub-step against it
directly.
"""

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.core.state import init_state as jax_init_state
from mcjax.models.potentials import LennardJones as JaxLJ
from mcjax.ops import cells as jcells
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch.ops import cells, cuda_shift, cuda_substep
from shared_reference import shared

KW = dict(dim=3, n_atoms=500, box_length=10.0, cells_per_side=4, nmax=24,
          n_moves=3, proposal="gaussian", step_size=0.2, beta=0.5, seed=0)
JCFG = JaxConfig(**KW)
CFG = mt.SimConfig(**KW)
JPOT = JaxLJ(r_cut=2.5)
POT = mt.LennardJones(r_cut=2.5)
N_SWEEPS = 3

NEAR_TIE = 1e-5     # relative distance of acc_u from exp(-beta dE)
DE_REL, DE_ABS = 1e-5, 1e-4
ANCHOR_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _log(log, kind, *arrays):
    log.append((kind, *(np.array(a) for a in arrays)))


def _reference():
    """mcjax's 3-sweep run: per sweep a list of sub-steps, each
    (color, pos in, own out, dE, accepted, proposed, pick_u, disp, acc_u),
    and the shift (pos in, occ, axis, d, pos out, occ out, overflow); plus
    the initial and final states and the per-sweep metrics."""
    log = []

    def record_substep(cfg, pot, color, pos, occ, key, shift_fn, beta,
                       block_offset):
        out = jsweep.color_substep(cfg, pot, color, pos, occ, key, shift_fn,
                                   beta, block_offset)
        draws = jsweep.substep_randoms(cfg, key, cfg.block_shape)
        jax.debug.callback(partial(_log, log, color), pos, *out, *draws,
                           ordered=True)
        return out

    def defer_shift(cfg, pos, occ, axis, d, shift_fn, block_offset):
        jax.debug.callback(partial(_log, log, "shift"), axis, d,
                           ordered=True)
        return pos, occ, jnp.any(occ < 0)

    sweep = jax.jit(partial(jsweep.mc_sweep, JCFG, JPOT,
                            substep_fn=record_substep,
                            shift_rebin_fn=defer_shift))
    st0 = jax_init_state(JCFG, positions=jcells.stratified_positions(JCFG))
    st, sweeps, metrics = st0, [], []
    for _ in range(N_SWEEPS):
        st, m = sweep(st)
        jax.effects_barrier()
        (_, axis, d), subs = log[-1], log[:-1]
        log.clear()
        with jax.disable_jit():
            pos, occ, ovf = jcells.shift_rebin(JCFG, st.pos, st.occ, axis, d)
        shift = (np.array(st.pos), np.array(st.occ), axis, d,
                 np.array(pos), np.array(occ), bool(ovf))
        st = dataclasses.replace(st, pos=pos, occ=occ,
                                 overflow=st.overflow | ovf)
        sweeps.append((subs, shift))
        metrics.append((float(m.delta_e), int(m.accepted), int(m.proposed),
                        bool(ovf)))
    return _state(st0), _state(st), sweeps, metrics


def _state(st) -> dict:
    return dict(pos=np.array(st.pos), occ=np.array(st.occ))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``_reference``, built once per run (numpy only)."""
    st0, st, sweeps, metrics = shared(tmp_path_factory, "torch_lj3d_reference",
                                      _reference)
    return (SimpleNamespace(**st0), SimpleNamespace(**st), sweeps,
            metrics)


def port_substep(entry, occ):
    """The port's plain sub-step on mcjax's state before it: (new own
    block, dE, accepted, proposed, record)."""
    color, pos_in, *_, pick_u, disp, acc_u = entry
    rec = {}
    out = cuda_substep.color_substep(
        CFG, POT, int(color), torch.from_numpy(pos_in.copy()),
        torch.from_numpy(occ), torch.from_numpy(pick_u),
        torch.from_numpy(disp), torch.from_numpy(acc_u), rec)
    return (*out, rec)


@pytest.fixture(scope="module")
def substeps(reference):
    """Every recorded sub-step compared with the port's: a list of
    (sweep, color, cells that differ, near-tie cells, checks passed)."""
    st0, _, sweeps, _ = reference
    occ = np.array(st0.occ)
    out = []
    for s, (subs, shift) in enumerate(sweeps):
        for entry in subs:
            color, _, own_want, de_want, na, np_ = entry[:6]
            own, de, acc, prop, rec = port_substep(entry, occ)
            differs = (_bits(own.numpy()) != _bits(own_want)).any(axis=(0, 1))
            ties = (rec["margin"] <= NEAR_TIE).numpy()
            ok = (not (differs & ~ties).any() and int(prop) == int(np_)
                  and (differs.any() or (
                      int(acc) == int(na)
                      and abs(float(de) - float(de_want))
                      <= DE_REL * abs(float(de_want)) + DE_ABS)))
            out.append((s, int(color), int(differs.sum()), int(ties.sum()),
                        ok))
        occ = shift[5]
    return out


@pytest.mark.parametrize("color", range(8))
def test_color_substep_matches_mcjax(substeps, color):
    """Each sub-step of this color (one per sweep), from mcjax's state
    before it: bit for bit outside near-tie cells, dE within tolerance."""
    mine = [r for r in substeps if r[1] == color]
    assert len(mine) == N_SWEEPS
    for s, _, n_diff, n_ties, ok in mine:
        assert ok, (s, color, n_diff, n_ties)
    print(f"color {color}: near-tie cells {sum(r[3] for r in mine)}, "
          f"cells differing {sum(r[2] for r in mine)}")


@pytest.mark.parametrize("sweep", range(N_SWEEPS))
def test_shift_matches_mcjax(reference, sweep):
    """The port's 3D grid shift on mcjax's state before each shift."""
    pos, occ, axis, d, pos_want, occ_want, ovf_want = reference[2][sweep][1]
    got_pos, got_occ, got_ovf = cuda_shift.shift(
        CFG, torch.from_numpy(pos), torch.from_numpy(occ),
        torch.from_numpy(axis).to(torch.int32), torch.from_numpy(d))
    assert_bitwise(got_pos, pos_want)
    assert_bitwise(got_occ, occ_want)
    assert bool(got_ovf) == ovf_want is False


class Replay:
    """Provider that hands the port the random numbers mcjax drew."""

    def __init__(self, sweeps):
        self.sweeps = sweeps

    def schedule(self, cfg, sweep):
        subs, shift = self.sweeps[sweep]
        perm = torch.tensor([int(e[0]) for e in subs], dtype=torch.int32)
        return (perm, torch.from_numpy(shift[2]).to(torch.int32),
                torch.from_numpy(shift[3]))

    def substep(self, cfg, sweep, i, need_acc):
        assert need_acc
        return tuple(torch.from_numpy(a) for a in self.sweeps[sweep][0][i][6:])


def test_run_sweeps_matches_mcjax(reference, substeps):
    """Three sweeps with shifts through the port's entry points, from the
    port's own binning of the stratified start."""
    st0, st, sweeps, metrics = reference
    start = mt.init_state(CFG, "cpu", cells.stratified_positions(CFG))
    assert_bitwise(start.pos, st0.pos)
    assert_bitwise(start.occ, st0.occ)
    got, m = mt.run_sweeps(CFG, POT, start, N_SWEEPS, Replay(sweeps))
    differing = sum(r[2] for r in substeps)
    print(f"near-tie cells that differ: {differing}")
    if differing == 0:
        assert_bitwise(got.pos, st.pos)
        assert_bitwise(got.occ, st.occ)
        de, acc, prop, ovf = (np.array(v) for v in zip(*metrics))
        np.testing.assert_array_equal(m.accepted.numpy(), acc)
        np.testing.assert_array_equal(m.proposed.numpy(), prop)
        np.testing.assert_array_equal(m.overflow.numpy(), ovf)
        np.testing.assert_allclose(m.delta_e.numpy(), de, rtol=DE_REL,
                                   atol=DE_ABS)
    assert got.sweep == N_SWEEPS and not bool(got.overflow)
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    mt.validate_state(CFG, got, POT)


def test_energy_anchor(monkeypatch):
    """A 4-sweep plain run with the port's own draws: the summed dE equals
    the float64 energy difference (cell lists) within ANCHOR_REL, once the
    grid shifts' own energy changes are added to it.

    dE counts the moves only. A grid shift is a translation, but it
    re-rounds every coordinate (x - d, then the wrap), and the unshifted LJ
    jumps by u(r_cut) = -0.0163 where a pair crosses the cutoff. Here the
    cells are exactly r_cut wide, so the stratified start has pairs at
    exactly r_cut, and the first shifts change E by about 0.6 each (the
    JAX package's shift does the same, bit for bit: test_shift_matches_mcjax).
    The test measures each shift's change and prints it."""
    energy = partial(mt.total_energy_cells, CFG, POT, dtype=torch.float64)
    shifts = []
    plain_shift = cuda_shift.shift

    def measured_shift(cfg, pos, occ, axis, d):
        out = plain_shift(cfg, pos, occ, axis, d)
        shifts.append(float(energy(out[0], out[1]) - energy(pos, occ)))
        return out

    monkeypatch.setattr(cuda_shift, "shift", measured_shift)
    st = mt.init_state(CFG, "cpu", cells.stratified_positions(CFG))
    e0 = float(energy(st.pos, st.occ))
    rnd = mt.TorchRandoms(torch.Generator().manual_seed(3))
    st, m = mt.run_sweeps(CFG, POT, st, 4, rnd)
    e1 = float(energy(st.pos, st.occ))
    de = float(m.delta_e.double().sum())
    print(f"E {e0} -> {e1}; summed dE {de}; shifts changed E by {shifts}")
    assert len(shifts) == 4
    assert abs((e1 - e0) - (de + sum(shifts))) <= \
        ANCHOR_REL * max(1.0, abs(e1 - e0)), (e0, e1, de, shifts)
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    assert mt.validate_state(CFG, st, POT)["overlap_depth_ulps"] == 0.0


@pytest.mark.parametrize("eps,sigma,r_cut,shift", [
    (1.0, 1.0, 2.5, False), (1.0, 1.0, 2.5, True), (0.7, 1.1, 2.9, True)])
def test_lj_pair_energy_bitwise(eps, sigma, r_cut, shift):
    """LennardJones.pair_energy equals mcjax's on r2 samples, the guarded
    r2 = 0, the cutoff and values past it included."""
    rc2 = np.float32(r_cut * r_cut)
    r2 = np.concatenate([
        np.float32([0.0, 1e-13, 1e-12, 0.5, rc2, np.nextafter(rc2, 2 * rc2),
                    2 * rc2, 1e4]),
        np.random.default_rng(5).uniform(0.6, 1.2 * rc2, 20000)
    ]).astype(np.float32)
    want = np.asarray(jax.jit(JaxLJ(eps, sigma, r_cut, shift).pair_energy)(r2))
    pot = mt.LennardJones(eps, sigma, r_cut, shift)
    got = pot.pair_energy(torch.from_numpy(r2))
    assert_bitwise(got, want)
    assert not bool(pot.overlap(torch.from_numpy(r2)).any())


@pytest.mark.parametrize("n,box,cps,dim", [
    (500, 10.0, 4, 3), (1_000_000, 107.72173504382, 42, 3),
    (2048, 80.0, 30, 2)])
def test_stratified_positions_bitwise(n, box, cps, dim):
    kw = dict(dim=dim, n_atoms=n, box_length=box, cells_per_side=cps,
              nmax=24)
    want = np.asarray(jcells.stratified_positions(JaxConfig(**kw)))
    assert_bitwise(cells.stratified_positions(mt.SimConfig(**kw)), want)


@pytest.mark.parametrize("seam_axis,shift_axis", [
    (0, 1), (1, 2), (2, 0), (0, 0), (1, 1), (2, 2)])
def test_shift_keeps_seam_coordinates_on_their_side_3d(seam_axis,
                                                       shift_axis):
    """A slot at +L/2 on each axis stays there through a shift along each
    axis (the 3D form of test_torch_cells.py's seam test)."""
    cfg = CFG.replace(n_atoms=1)
    h = np.float32(cfg.box_length / 2)
    x = np.float32([0.3, -1.1, 2.2])
    x[seam_axis] = h
    c = np.floor((x.astype(np.float64) + h) / cfg.cell_width).astype(int)
    c[seam_axis] = cfg.cells_per_side - 1
    color = int(sum((c[k] & 1) << k for k in range(3)))
    blk = tuple(int(v) >> 1 for v in c)
    st = mt.zeros_state(cfg, device="cpu")
    st.occ[(color, *blk)] = 1
    st.pos[(color, slice(None), 0, *blk)] = torch.from_numpy(x)
    d = 0.3 if shift_axis != seam_axis else float(np.spacing(h)) / 4
    pos, occ, ovf = cuda_shift.shift(
        cfg, st.pos, st.occ, torch.tensor(shift_axis, dtype=torch.int32),
        torch.tensor(d, dtype=torch.float32))
    (c2, *b2), = torch.nonzero(occ).tolist()
    assert b2[seam_axis] == blk[seam_axis] and (c2 >> seam_axis) & 1 == 1
    got = float(pos[(c2, seam_axis, 0, *b2)])
    assert abs(got - h) <= 2 * np.spacing(h)
    mt.validate_state(cfg, mt.SimState(pos=pos, occ=occ, sweep=1,
                                       overflow=ovf), POT)
