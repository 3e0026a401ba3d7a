"""Kob-Andersen mixtures: the port's plain path held against mcjax.ops.mixture.

Two configurations, both the Kob-Andersen 80:20 model (shifted, r_cut 2.5
sigma per pair):
* KA, mcjax's ``ka_cfg`` (tests/test_mixture.py): 100 atoms in a box of 10
  cut into 4^3 cells, nmax 12, n_moves 6, gaussian step 0.15, beta 1, at
  uniform random positions with species 1 at a fraction 0.2 (numpy, seeded);
* DENSE, ka3d's density and capacity: 1,200 atoms in a box of 10 (rho 1.2),
  4^3 cells, nmax 34, n_moves 4, gaussian step 0.09, beta 1.25, stratified
  start, species 1 where i % 5 == 4.

The reference run is mcjax's ``mc_sweep`` on KA, jitted once, its color
sub-steps (``mcjax.ops.mixture.color_substep_mixture``, which ``mc_sweep``
picks for a mixture) reported with their draws through
``jax.debug.callback``, and each grid shift run op by op between sweeps, as
tests/test_torch_lj3d.py does for LJ. The port is fed the same random
numbers.

Gates, with their tolerances:
* pair energies, binning, unbinning, neighbor stacks and the grid shift
  with the species plane equal mcjax's bit for bit;
* sub-steps and the 3-sweep run: positions, species planes, occupancies,
  accept and propose counts and the overflow flag bit for bit, except in
  cells where a decision came within a relative NEAR_TIE of a tie (counted
  and printed; no other cell may differ); dE within DE_REL + DE_ABS;
* the float32 cell total: every pair term is mcjax's, but XLA on the CPU
  sums the ~1e5 terms in an order PyTorch does not reproduce (neither
  sequential nor pairwise nor a fixed lane count), so the two float32 sums
  agree within F32_TOTAL_REL (measured 9.8e-7: mcjax's sum lies 8.3e-7
  from the float64 total, the port's 1.5e-7); the float64 cell total meets
  the O(N^2) oracle within F64_REL;
* a plain run's summed dE plus its grid shifts' measured energy changes
  equals the float64 energy difference within ANCHOR_REL (see
  tests/test_torch_lj3d.py::test_energy_anchor), and the A and B
  populations are conserved.
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
from mcjax.models.mixtures import LJMixture as JaxLJMixture
from mcjax.models.mixtures import kob_andersen as jax_kob_andersen
from mcjax.ops import cells as jcells
from mcjax.ops import mixture as jmix
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch.ops import cells, cuda_shift, cuda_substep, mixture
from shared_reference import shared

KA_KW = dict(dim=3, n_atoms=100, box_length=10.0, cells_per_side=4, nmax=12,
             n_moves=6, proposal="gaussian", step_size=0.15, beta=1.0,
             seed=0)
DENSE_KW = dict(dim=3, n_atoms=1200, box_length=10.0, cells_per_side=4,
                nmax=34, n_moves=4, proposal="gaussian", step_size=0.09,
                beta=1.0 / 0.8, seed=0)
JCFG, CFG = JaxConfig(**KA_KW), mt.SimConfig(**KA_KW)
JDENSE, DENSE = JaxConfig(**DENSE_KW), mt.SimConfig(**DENSE_KW)
JPOT, POT = jax_kob_andersen(), mt.kob_andersen()
N_SWEEPS = 3

NEAR_TIE = 1e-5     # relative distance of acc_u from exp(-beta dE)
DE_REL, DE_ABS = 1e-5, 1e-4
ANCHOR_REL = 1e-3
F32_TOTAL_REL = 1e-5
F64_REL = 1e-6


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


def ka_start():
    rng = np.random.default_rng(1)
    r = rng.uniform(-5.0, 5.0, (CFG.n_atoms, 3)).astype(np.float32)
    spec = (rng.uniform(size=CFG.n_atoms) < 0.2).astype(np.int32)
    return r, spec


def dense_start():
    r = cells.stratified_positions(DENSE).numpy()
    return r, (np.arange(DENSE.n_atoms) % 5 == 4).astype(np.int32)


def jax_shift(cfg, pos, occ, axis, d):
    """mcjax's grid shift, op by op (compiled for 3D it costs far more)."""
    with jax.disable_jit():
        out = jcells.shift_rebin(cfg, jnp.asarray(pos), jnp.asarray(occ),
                                 jnp.int32(axis), jnp.float32(d))
    return tuple(np.array(a) for a in out)


def _reference():
    """mcjax's 3-sweep KA run: per sweep a list of sub-steps, each
    (color, pos in, own out, dE, accepted, proposed, pick_u, disp, acc_u),
    and the shift (pos in, occ, axis, d, pos out, occ out, overflow); plus
    the initial and final states and the per-sweep metrics."""
    log = []

    def record_substep(cfg, pot, color, pos, occ, key, shift_fn, beta,
                       block_offset):
        out = jmix.color_substep_mixture(cfg, pot, color, pos, occ, key,
                                         shift_fn, beta, block_offset)
        draws = jsweep.substep_randoms(cfg, key, cfg.block_shape, True)
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
    st0 = jax.jit(partial(jmix.init_mixture_state, JCFG))(*ka_start())
    st, sweeps, metrics = st0, [], []
    for _ in range(N_SWEEPS):
        st, m = sweep(st)
        jax.effects_barrier()
        (_, axis, d), subs = log[-1], log[:-1]
        log.clear()
        pos, occ, ovf = jax_shift(JCFG, st.pos, st.occ, axis, d)
        shift = (np.array(st.pos), np.array(st.occ), axis, d, pos, occ,
                 bool(ovf))
        st = dataclasses.replace(st, pos=jnp.asarray(pos),
                                 occ=jnp.asarray(occ),
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
    st0, st, sweeps, metrics = shared(tmp_path_factory, "torch_mixture_reference",
                                      _reference)
    return (SimpleNamespace(**st0), SimpleNamespace(**st), sweeps,
            metrics)


@pytest.fixture(scope="module")
def substeps(reference):
    """Every recorded sub-step against the port's plain one on the same
    state and draws: a list of (sweep, color, cells that differ, near-tie
    cells, checks passed)."""
    st0, _, sweeps, _ = reference
    occ = np.array(st0.occ)
    out = []
    for s, (subs, shift) in enumerate(sweeps):
        for entry in subs:
            color, pos_in, own_want, de_want, na, np_ = entry[:6]
            rec = {}
            own, de, acc, prop = mixture.color_substep_mixture(
                CFG, POT, int(color), torch.from_numpy(pos_in.copy()),
                torch.from_numpy(occ),
                *(torch.from_numpy(a) for a in entry[6:]), rec)
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
def test_color_substep_mixture_matches_mcjax(substeps, color):
    """Each sub-step of this color (one per sweep), from mcjax's state
    before it: bit for bit (species plane included) outside near-tie
    cells, dE within tolerance."""
    mine = [r for r in substeps if r[1] == color]
    assert len(mine) == N_SWEEPS
    for s, _, n_diff, n_ties, ok in mine:
        assert ok, (s, color, n_diff, n_ties)
    print(f"color {color}: near-tie cells {sum(r[3] for r in mine)}, "
          f"cells differing {sum(r[2] for r in mine)}")


@pytest.mark.parametrize("sweep", range(N_SWEEPS))
def test_shift_in_run_matches_mcjax(reference, sweep):
    """The port's grid shift on mcjax's state before each shift of the
    run, species plane included."""
    pos, occ, axis, d, pos_want, occ_want, ovf_want = reference[2][sweep][1]
    got_pos, got_occ, got_ovf = cuda_shift.shift(
        CFG, torch.from_numpy(pos), torch.from_numpy(occ),
        torch.from_numpy(axis).to(torch.int32), torch.from_numpy(d))
    assert_bitwise(got_pos, pos_want)
    assert_bitwise(got_occ, occ_want)
    assert bool(got_ovf) == ovf_want is False


@pytest.mark.parametrize("axis", range(3))
@pytest.mark.parametrize("sign", [1, -1])
def test_shift_with_species_bitwise(reference, axis, sign):
    """The shift carries the species plane: 3 axes x 2 signs on the final
    state of the reference run (the seam guard is the port's one
    departure, and no slot here lies on the seam)."""
    st = reference[1]
    d = np.float32(sign * 0.3)
    want = jax_shift(JCFG, st.pos, st.occ, axis, d)
    pos, occ = (torch.from_numpy(np.array(a)) for a in (st.pos, st.occ))
    got = cuda_shift.shift(CFG, pos, occ,
                           torch.tensor(axis, dtype=torch.int32),
                           torch.tensor(d))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    assert bool(got[2]) == bool(want[2]) is False
    assert torch.equal(mixture.species_counts(CFG, got[0], got[1], 2),
                       mixture.species_counts(CFG, pos, occ, 2))


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
    port's own binning of the start."""
    st0, st, sweeps, metrics = reference
    start = mt.init_mixture_state(CFG, *(torch.from_numpy(a)
                                         for a in ka_start()), device="cpu")
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
    n_b = int(ka_start()[1].sum())
    mt.validate_state(CFG, got, POT,
                      expect_species=[CFG.n_atoms - n_b, n_b])


@pytest.fixture(scope="module")
def dense_reference(tmp_path_factory):
    """mcjax's binning, unbinning, neighbor stacks and float32 cell total
    of the DENSE start, compiled as one function (built once per run)."""
    return shared(tmp_path_factory, "torch_mixture_dense_reference",
                  _dense_reference)


def _dense_reference():
    def ref(r, s):
        st = jmix.init_mixture_state(JDENSE, r, s)
        flat = jmix.unbin_mixture(JDENSE, st.pos, st.occ)
        nbrs = [jcells.neighbor_stack(JDENSE, st.pos, st.occ, c)
                for c in range(8)]
        total = jmix.total_interaction_cells_mixture(JDENSE, JPOT, st.pos,
                                                     st.occ)
        return (st.pos, st.occ, st.overflow), flat, nbrs, total

    out = jax.jit(ref)(*dense_start())
    return jax.tree_util.tree_map(np.array, out)


@pytest.fixture(scope="module")
def dense_state():
    return mt.init_mixture_state(DENSE, *(torch.from_numpy(a)
                                          for a in dense_start()),
                                 device="cpu")


def test_init_and_unbin_mixture_bitwise(dense_reference, dense_state):
    (pos, occ, ovf), (flat_r, flat_s), _, _ = dense_reference
    assert dense_state.pos.shape == (8, 4, 34, 2, 2, 2)
    assert_bitwise(dense_state.pos, pos)
    assert_bitwise(dense_state.occ, occ)
    assert bool(dense_state.overflow) == bool(ovf) is False
    r, s = mt.unbin_mixture(DENSE, dense_state.pos, dense_state.occ)
    assert_bitwise(r, flat_r)
    assert_bitwise(s, flat_s)
    assert s.dtype == torch.int32


@pytest.mark.parametrize("color", range(8))
def test_neighbor_stack_with_species_bitwise(dense_reference, dense_state,
                                             color):
    """Four planes: the coordinate planes unwrapped across the box, the
    species plane read as it is."""
    nb_pos, nb_occ = dense_reference[2][color]
    got_pos, got_occ = cells.neighbor_stack(DENSE, dense_state.pos,
                                            dense_state.occ, color)
    assert got_pos.shape[1] == 4
    assert_bitwise(got_pos, nb_pos)
    assert_bitwise(got_occ, nb_occ)


def test_cell_totals(dense_reference, dense_state):
    """Float32 total against mcjax's (F32_TOTAL_REL: summation order);
    float64 total against the O(N^2) oracle (F64_REL)."""
    want, want_ov = dense_reference[3]
    e32, ov = mixture.total_interaction_cells_mixture(
        DENSE, POT, dense_state.pos, dense_state.occ)
    assert e32.dtype == torch.float32 and not bool(ov) and not bool(want_ov)
    assert abs(float(e32) - float(want)) <= F32_TOTAL_REL * abs(float(want))
    e64 = mt.total_energy_cells(DENSE, POT, dense_state.pos, dense_state.occ,
                                torch.float64)
    r, s = mt.unbin_mixture(DENSE, dense_state.pos, dense_state.occ)
    n2, n2_ov = mixture.total_energy_mixture_n2(POT, r.double(), s,
                                                DENSE.box_length)
    print(f"E float32 {float(e32)} (mcjax {float(want)}), float64 "
          f"{float(e64)}, O(N^2) {float(n2)}")
    assert abs(float(e64) - float(n2)) <= F64_REL * abs(float(n2))
    assert not bool(n2_ov)


def test_energy_anchor_and_populations(monkeypatch, dense_state):
    """A 3-sweep plain DENSE run with the port's own draws: the summed dE
    plus the shifts' measured energy changes equals the float64 energy
    difference within ANCHOR_REL; N, A and B are conserved."""
    energy = partial(mt.total_energy_cells, DENSE, POT, dtype=torch.float64)
    shifts = []
    plain_shift = cuda_shift.shift

    def measured_shift(cfg, pos, occ, axis, d):
        out = plain_shift(cfg, pos, occ, axis, d)
        shifts.append(float(energy(out[0], out[1]) - energy(pos, occ)))
        return out

    monkeypatch.setattr(cuda_shift, "shift", measured_shift)
    st = dataclasses.replace(dense_state, pos=dense_state.pos.clone(),
                             occ=dense_state.occ.clone())
    e0 = float(energy(st.pos, st.occ))
    rnd = mt.TorchRandoms(torch.Generator().manual_seed(3))
    st, m = mt.run_sweeps(DENSE, POT, st, 3, rnd)
    e1 = float(energy(st.pos, st.occ))
    de = float(m.delta_e.double().sum())
    print(f"E {e0} -> {e1}; summed dE {de}; shifts changed E by {shifts}")
    assert len(shifts) == 3
    assert abs((e1 - e0) - (de + sum(shifts))) <= \
        ANCHOR_REL * max(1.0, abs(e1 - e0)), (e0, e1, de, shifts)
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    mt.validate_state(DENSE, st, POT, expect_species=[960, 240])
    assert mixture.species_counts(DENSE, st.pos, st.occ, 2).tolist() == \
        [960, 240]


def test_validate_state_checks_species(dense_state):
    st = dataclasses.replace(dense_state, pos=dense_state.pos.clone())
    mt.validate_state(DENSE, st, POT, expect_species=[960, 240])
    with pytest.raises(mt.StateInvariantError, match="populations"):
        mt.validate_state(DENSE, st, POT, expect_species=[961, 239])
    color, *cell = (int(i) for i in torch.nonzero(st.occ)[0])
    st.pos[(color, 3, 0, *cell)] = 0.5
    with pytest.raises(mt.StateInvariantError, match="species ids"):
        mt.validate_state(DENSE, st, POT)
    st.pos[(color, 3, 0, *cell)] = 2.0
    with pytest.raises(mt.StateInvariantError, match="species ids"):
        mt.validate_state(DENSE, st, POT)


_EPS3 = ((1.0, 1.5, 0.7), (1.5, 0.5, 0.9), (0.7, 0.9, 1.2))
_SIG3 = ((1.0, 0.8, 0.9), (0.8, 0.88, 0.95), (0.9, 0.95, 1.1))
_KA_EPS, _KA_SIG = ((1.0, 1.5), (1.5, 0.5)), ((1.0, 0.8), (0.8, 0.88))
MODELS = {
    "ka": (_KA_EPS, _KA_SIG, None, True),
    "ka_unshifted": (_KA_EPS, _KA_SIG, None, False),
    "binary_cutoffs": (_KA_EPS, _KA_SIG, ((2.5, 2.2), (2.2, 2.3)), True),
    "three_species": (_EPS3, _SIG3, None, True),
}


def _tables(name):
    eps, sig, rc, shift = MODELS[name]
    if rc is None:
        rc = tuple(tuple(2.5 * s for s in row) for row in sig)
    return eps, sig, rc, shift


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pair_energy_s_bitwise(name):
    """LJMixture.pair_energy_s equals mcjax's, built from the same tables,
    on r2 samples (the guarded r2 = 0 and the cutoffs included) and every
    species pair."""
    tables = _tables(name)
    n_s = len(tables[0])
    rng = np.random.default_rng(7)
    r2 = np.concatenate([
        np.float32([0.0, 1e-13, 0.64 * 6.25, 6.25,
                    np.nextafter(np.float32(6.25), np.float32(7)), 1e4]),
        rng.uniform(0.3, 8.0, 30000)]).astype(np.float32)
    si = rng.integers(0, n_s, r2.size).astype(np.float32)
    sj = rng.integers(0, n_s, r2.size).astype(np.float32)
    want = np.asarray(jax.jit(JaxLJMixture(*tables).pair_energy_s)(r2, si,
                                                                   sj))
    pot = mt.LJMixture(*tables)
    t = [torch.from_numpy(a) for a in (r2, si, sj)]
    assert_bitwise(pot.pair_energy_s(*t), want)
    assert not bool(pot.overlap_s(*t).any())
    assert pot.n_species == n_s and pot.r_cut == max(map(max, tables[2]))


def test_kernel_library_dispatch():
    """The mixture kernel covers binary LJ mixtures with one cutoff ratio
    and nmax <= 64; anything else raises before a launch."""
    cfg = DENSE
    assert cuda_substep.kernel_library(cfg, POT) is cuda_substep.LIB_MIX
    assert cuda_substep.kernel_library(cfg.replace(nmax=64), POT) is \
        cuda_substep.LIB_MIX
    for c, pot in [(cfg, mt.LJMixture(*_tables("three_species")[:3])),
                   (cfg, mt.LJMixture(*_tables("binary_cutoffs")[:3])),
                   (cfg.replace(nmax=65), POT),
                   (cfg.replace(dim=2), POT)]:
        with pytest.raises(NotImplementedError, match="kernel"):
            cuda_substep.kernel_library(c, pot)
    # the field form of the mixture sub-step is ported; a three-species
    # mixture still has no kernel form, field or not
    with pytest.raises(NotImplementedError, match="has 3 species"):
        cuda_substep.kernel_library(
            cfg, mt.LJMixture(*_tables("three_species")[:3]))


def test_state_from_numpy_carries_species(dense_reference):
    (pos, occ, ovf), *_ = dense_reference
    st = mt.state_from_numpy(pos, occ, np.int32(2), ovf, device="cpu")
    assert st.pos.shape[1] == 4
    back = mt.state_to_numpy(st)
    assert_bitwise(back[0], pos)
    assert_bitwise(back[1], occ)
    mt.validate_state(DENSE, st, POT, expect_species=[960, 240])
