"""The port's single-species pair models held against mcjax on the CPU.

* Carrying a model across: every mcjax model, a fitted
  ``PolynomialPotential`` included, through ``potential_to_dict`` ->
  ``mcjax_torch.convert.potential_from_spec`` becomes the port's model with
  the same parameters; the port's registry round-trips its own models;
  ``fit_pair_polynomial`` gives mcjax's coefficients on the same table.
* Pair energies on a grid of r^2 in float32: bit for bit for the models
  whose arithmetic is +, x, / and fma (hard spheres, square wells, LJ,
  WCA, even soft spheres, polynomials), with XLA's fma sites shown to
  matter; within a stated number of float32 ulps where exp, sqrt or pow
  enter (Yukawa, Morse, odd soft spheres), measured here.
* The O(N^2) energy oracle (``mcjax_torch.models.reference``) against
  mcjax's, and as the plain runs' anchor: no overlap, and the summed dE
  equal to the oracle's energy change.
* The plain sweep against mcjax's, fed mcjax's own draws: 3D hard spheres,
  3D and 2D square wells (``run``: mcjax's ``mc_sweep``, the body of its
  ``run_sweeps`` scan, jitted once and called once per sweep, each color
  sub-step recorded through ``jax.debug.callback`` and each grid shift run
  op by op, as ``tests/test_torch_lj3d.py`` does), and the 2D polynomial
  configuration of ``tests/test_pallas.py:89`` (each color's
  ``color_substep``). Positions, occupancies, counts and dE bit for bit,
  except in a cell where an accept decision came within NEAR_TIE of a tie
  (square wells: exp(-beta dE) of an integer dE, which the two libraries
  may round an ulp apart; the smooth polynomial: dE summed in another
  order), whose count is printed.
* The kernels' dispatch: ``kernel_library`` sends every pair model to a
  hand-written kernel, and the forms this slice leaves out (a Philox key,
  an NPT scale, a field) raise NotImplementedError rather than run the
  plain version (checked on the meta device, which has no kernels).

Each mcjax reference is built once per run (``shared_reference``), small
(8^3 cells in 3D, 10^2 in 2D, two or three sweeps).
"""

import dataclasses
import json
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.core.state import init_state as jax_init_state
from mcjax.models import mixtures as jmix
from mcjax.models import potentials as jp
from mcjax.models import reference as jref
from mcjax.ops import cells as jcells
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch import convert
from mcjax_torch.models import potentials as tp
from mcjax_torch.models import reference as tref
from mcjax_torch.ops import cuda_substep
from mcjax_torch.ops.random import PhiloxKey
from shared_reference import shared

NEAR_TIE = 1e-5     # relative distance of acc_u from exp(-beta dE)
DE_REL, DE_ABS = 1e-5, 1e-4


def _lj_table(r_cut: float, lo: float, n: int):
    """LJ shifted to zero at r_cut on n samples in [lo, r_cut] (float64)."""
    r = np.linspace(lo, r_cut, n)
    shift = 4.0 * (r_cut ** -12 - r_cut ** -6)
    return r, 4.0 * (r ** -12 - r ** -6) - shift


JAX_MODELS = {
    "hard": jp.HardSphere(1.0),
    "lj": jp.LennardJones(r_cut=2.5),
    "lj_shifted": jp.LennardJones(0.7, 1.1, 2.9, True),
    "wca": jp.WCA(),
    "wca_scaled": jp.WCA(1.3, 1.1),
    "soft": jp.SoftSphere(),
    "soft6": jp.SoftSphere(0.8, 1.2, 6, 2.5),
    "soft9": jp.SoftSphere(1.0, 1.0, 9, 2.5),
    "sw": jp.SquareWell(),
    "sw_narrow": jp.SquareWell(0.7, 1.1, 1.4),
    "yukawa": jp.Yukawa(r_cut=3.0),
    "morse": jp.Morse(),
    "morse_scaled": jp.Morse(1.5, 1.1, 4.0, 2.5, True),
    "morse_unshifted": jp.Morse(shift=False),
    "poly": jp.fit_pair_polynomial(*_lj_table(2.0, 0.85, 400), degree=8,
                                   r_cut=2.0),
    "poly_core": jp.fit_pair_polynomial(*_lj_table(2.0, 0.85, 400),
                                        degree=8, r_cut=2.0,
                                        core_diameter=0.9),
}

# Largest difference from mcjax's float32 energy, in float32 ulps of
# max(|e|, eps), eps the model's energy scale, where exp, sqrt or pow
# enter (measured on this grid: Yukawa 5, Morse 21 to 25, the odd soft
# sphere 1, all at most these bounds); every other model is bit for bit.
ULPS = {"soft9": 2, "yukawa": 8, "morse": 32, "morse_scaled": 32,
        "morse_unshifted": 32}


def port_model(name):
    return convert.potential_from_spec(
        convert.potential_to_spec(JAX_MODELS[name]))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_models_carry_across(name):
    """mcjax model -> potential_to_dict -> potential_from_spec: the port's
    class of the same name with equal parameters; the spec is plain JSON;
    the port's registry round-trips the port's model."""
    jm = JAX_MODELS[name]
    spec = convert.potential_to_spec(jm)
    assert json.loads(json.dumps(spec)) == spec
    assert spec == json.loads(json.dumps(jp.potential_to_dict(jm)))
    tm = convert.potential_from_spec(spec)
    assert type(tm).__name__ == type(jm).__name__
    for f in dataclasses.fields(jm):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert (tm.r_cut, tm.has_energy, tm.has_hard_core) == \
        (jm.r_cut, jm.has_energy, jm.has_hard_core)
    assert tp.potential_from_dict(tp.potential_to_dict(tm)) == tm


def test_registry_knows_mixtures_and_refuses_the_rest():
    ka = mt.kob_andersen()
    spec = convert.potential_to_spec(jmix.kob_andersen())
    assert convert.potential_from_spec(spec) == ka
    with pytest.raises(ValueError, match="unknown potential kind"):
        convert.potential_from_spec({"kind": "HardSphereMixture",
                                     "params": {}})


def test_fit_pair_polynomial_matches_mcjax():
    """The same numpy arithmetic: the same coefficients, to the bit, with
    and without a core; a fit too poor raises in both packages."""
    for kw in ({}, {"core_diameter": 0.9}, {"degree": 6}):
        r, e = _lj_table(2.0, 0.8, 500)
        want = jp.fit_pair_polynomial(r, e, r_cut=2.0, **kw)
        got = mt.fit_pair_polynomial(r, e, r_cut=2.0, **kw)
        assert got.coeffs == want.coeffs and got.r_cut == want.r_cut
        assert got.core_diameter == want.core_diameter
    r, e = _lj_table(2.5, 0.7, 300)
    for fit in (jp.fit_pair_polynomial, mt.fit_pair_polynomial):
        with pytest.raises(ValueError, match="residual"):
            fit(r, e, degree=2, r_cut=2.5)


def _r2_grid(jm):
    """float32 r^2 samples: the guarded 0, the core and the cutoff with
    their neighbors, values past the cutoff, and 20,000 uniform ones."""
    rc2 = np.float32(jm.r_cut * jm.r_cut)
    edges = [np.float32(0.0), np.float32(1e-13), np.float32(1e-12),
             rc2, np.nextafter(rc2, np.float32(0)),
             np.nextafter(rc2, np.float32(2 * rc2)), np.float32(2 * rc2),
             np.float32(1e4)]
    core = getattr(jm, "diameter", getattr(jm, "core_diameter", 0.0))
    if core:
        c2 = np.float32(core * core)
        edges += [c2, np.nextafter(c2, np.float32(0)),
                  np.nextafter(c2, np.float32(2))]
    rng = np.random.default_rng(5)
    return np.concatenate([np.array(edges, np.float32),
                           rng.uniform(0.3, 1.2 * rc2, 20000)]
                          ).astype(np.float32)


def _separately_rounded(name, jm, r2):
    """WCA's and the polynomial's energy with every product rounded before
    its sum (no fma), or None for a model without a contraction site."""
    f32 = np.float32
    inv = (f32(1.0) / np.maximum(r2, f32(1e-12))).astype(f32)
    if name.startswith("poly"):     # past the cutoff only: no overflow
        inv = np.where(r2 >= f32(0.3), inv, f32(1.0))
    if name.startswith("wca"):
        inv2 = f32(jm.sigma * jm.sigma) * inv
        inv6 = inv2 * inv2 * inv2
        e = f32(4 * jm.epsilon) * (inv6 * inv6 - inv6) + f32(jm.epsilon)
    elif name.startswith("poly"):
        e = np.full(r2.shape, f32(jm.coeffs[-1]))
        for c in reversed(jm.coeffs[:-1]):
            e = e * inv + f32(c)
    else:
        return None
    return np.where(r2 <= f32(jm.r_cut * jm.r_cut), e, f32(0))


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
@np.errstate(over="ignore", invalid="ignore")   # r2 -> 0 overflows to inf
def test_pair_energy_matches_mcjax(name):
    """Each model's float32 pair energy and overlap against mcjax's
    (jitted) on the grid: bit for bit, or within ULPS[name] float32 ulps of
    max(|e|, eps). For WCA and the polynomial the product-rounded form
    differs from XLA's in over 1 % of the grid: the fma sites matter."""
    jm = JAX_MODELS[name]
    tm = port_model(name)
    r2 = _r2_grid(jm)
    want = np.asarray(jax.jit(jm.pair_energy)(r2))
    got = tm.pair_energy(torch.from_numpy(r2)).numpy()
    np.testing.assert_array_equal(
        tm.overlap(torch.from_numpy(r2)).numpy(),
        np.asarray(jax.jit(jm.overlap)(r2)))
    if name in ULPS:
        scale = np.maximum(np.abs(want), np.float32(
            getattr(jm, "epsilon", 1.0)))
        same = got == want          # the overflows to +inf included
        ulps = np.where(same, 0.0, np.abs(got.astype(np.float64) - want)
                        / np.spacing(scale))
        print(f"{name}: largest difference {ulps.max():.1f} ulps of "
              f"max(|e|, eps); {np.count_nonzero(ulps)} of {r2.size} differ")
        assert ulps.max() <= ULPS[name]
        return
    assert_bitwise(got, want)
    separate = _separately_rounded(name, jm, r2)
    if separate is not None:
        assert np.count_nonzero(separate != want) > 0.01 * want.size


@pytest.mark.parametrize("name", ["lj", "sw", "yukawa"])
def test_reference_energy_matches_mcjax(name):
    """The O(N^2) oracle: float64 total and particle energy against
    mcjax's float32 ones on 64 random points (no overlap flags raised
    spuriously), within rel 1e-5 (float32 sums)."""
    rng = np.random.default_rng(9)
    box = 6.0
    pos = rng.uniform(-box / 2, box / 2, (64, 3)).astype(np.float32)
    jm, tm = JAX_MODELS[name], port_model(name)
    e_j, ov_j = jax.jit(partial(jref.total_energy, jm, box_length=box))(pos)
    e_t, ov_t = tref.total_energy(tm, torch.from_numpy(pos).double(), box)
    assert bool(ov_t) == bool(ov_j)
    assert abs(float(e_t) - float(e_j)) <= 1e-5 * max(1.0, abs(float(e_j)))
    pe_j, _ = jax.jit(partial(jref.particle_energy, jm, box_length=box))(
        pos[3], pos, jnp.int32(3))
    pe_t, _ = tref.particle_energy(tm, torch.from_numpy(pos[3]).double(),
                                   torch.from_numpy(pos).double(), 3, box)
    assert abs(float(pe_t) - float(pe_j)) <= 1e-5 * max(1.0,
                                                        abs(float(pe_j)))


# The plain-path runs: model, SimConfig keywords (8^3 cells in 3D, 10^2
# in 2D), sweeps.
RUNS = {
    "hs3d": ("hard", dict(dim=3, n_atoms=500,
                          box_length=(500 * math.pi / 6 / 0.45) ** (1 / 3),
                          cells_per_side=8, nmax=8, n_moves=4,
                          proposal="uniform", step_size=0.12, beta=1.0,
                          seed=0), 2),
    "sw3d": ("sw", dict(dim=3, n_atoms=1210,
                        box_length=(1210 / 0.7) ** (1 / 3), cells_per_side=8,
                        nmax=8, n_moves=4, proposal="gaussian",
                        step_size=0.1, beta=0.5, seed=0), 2),
    "sw2d": ("sw", dict(dim=2, n_atoms=144,
                        box_length=math.sqrt(144 * math.pi / 4 / 0.5),
                        cells_per_side=10, nmax=8, n_moves=8,
                        proposal="uniform", step_size=0.18, beta=0.5,
                        seed=0), 3),
}


def _log(log, kind, *arrays):
    log.append((kind, *(np.array(a) for a in arrays)))


def _record_run(run):
    """mcjax's run: its start and end (pos, occ, overflow), and per sweep
    a list of sub-steps (color, pos in, own out, dE, accepted, proposed,
    pick_u, disp, acc_u) and the shift (pos in, occ, axis, d, pos out, occ
    out, overflow), all numpy."""
    name, kw, n_sweeps = RUNS[run]
    jcfg, jpot = JaxConfig(**kw), JAX_MODELS[name]
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

    sweep = jax.jit(partial(jsweep.mc_sweep, jcfg, jpot,
                            substep_fn=record_substep,
                            shift_rebin_fn=defer_shift))
    st = jax_init_state(jcfg)
    start = (np.array(st.pos), np.array(st.occ))
    sweeps = []
    for _ in range(n_sweeps):
        st, _ = sweep(st)
        jax.effects_barrier()
        (_, axis, d), subs = log[-1], log[:-1]
        log.clear()
        with jax.disable_jit():
            pos, occ, ovf = jcells.shift_rebin(jcfg, st.pos, st.occ, axis, d)
        sweeps.append((subs, (np.array(st.pos), np.array(st.occ), axis, d,
                              np.array(pos), np.array(occ), bool(ovf))))
        st = dataclasses.replace(st, pos=pos, occ=occ,
                                 overflow=st.overflow | ovf)
    return start, (np.array(st.pos), np.array(st.occ),
                   bool(st.overflow)), sweeps


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request, tmp_path_factory):
    return request.param, shared(tmp_path_factory,
                                 f"pairs_run_{request.param}",
                                 partial(_record_run, request.param))


class Replay:
    """Provider that hands the port the random numbers mcjax drew."""

    def __init__(self, sweeps, need_acc):
        self.sweeps, self.need_acc = sweeps, need_acc

    def schedule(self, cfg, sweep):
        subs, shift = self.sweeps[sweep]
        perm = torch.tensor([int(e[0]) for e in subs], dtype=torch.int32)
        return (perm, torch.from_numpy(shift[2]).to(torch.int32),
                torch.from_numpy(shift[3]))

    def substep(self, cfg, sweep, i, need_acc):
        assert need_acc == self.need_acc
        pick_u, disp, acc_u = self.sweeps[sweep][0][i][6:]
        return (torch.from_numpy(pick_u), torch.from_numpy(disp),
                torch.from_numpy(acc_u) if need_acc else None)


def oracle_energy(cfg, pot, st):
    """(total energy, any overlap) of a state by the port's O(N^2) oracle
    (``models.reference``) in float64."""
    r = mt.ops.cells.unbin(cfg, st.pos, st.occ).double()
    e, ov = tref.total_energy(pot, r, cfg.box_length)
    return float(e), bool(ov)


def test_plain_run_matches_mcjax(run):
    """Each recorded sub-step through the port's plain ``color_substep``
    from mcjax's state before it (bit for bit outside near-tie cells, and
    counts and dE exactly where no cell differs), each shift bit for bit,
    then the whole run through the port's ``run_sweeps`` fed mcjax's draws:
    bit for bit in positions, occupancies, counts and dE when no near tie
    decided differently (the count of such cells is printed)."""
    key, ((pos0, occ0), (pos1, occ1, ovf1), sweeps) = run
    name, kw, n_sweeps = RUNS[key]
    cfg, pot = mt.SimConfig(**kw), port_model(name)
    occ = occ0
    differing = 0
    metrics = []
    for subs, shift in sweeps:
        de_sweep = np.float32(0.0)
        acc_sweep = prop_sweep = 0
        for color, pos_in, own_want, de, na, np_, pick_u, disp, acc_u in subs:
            rec = {}
            own, t_de, t_acc, t_prop = cuda_substep.color_substep(
                cfg, pot, int(color), torch.from_numpy(pos_in.copy()),
                torch.from_numpy(occ), torch.from_numpy(pick_u),
                torch.from_numpy(disp),
                torch.from_numpy(acc_u) if pot.has_energy else None, rec)
            differs = (_bits(own.numpy()) != _bits(own_want)).any(axis=(0, 1))
            ties = (rec["margin"] <= NEAR_TIE).numpy() if "margin" in rec \
                else np.zeros_like(differs)
            assert not (differs & ~ties).any(), (key, int(color))
            assert int(t_prop) == int(np_)
            if not differs.any():
                assert int(t_acc) == int(na)
                assert_bitwise(t_de, de)
            differing += int(differs.sum())
            de_sweep += de
            acc_sweep += int(na)
            prop_sweep += int(np_)
        pos_in, occ_in, axis, d, pos_want, occ_want, ovf = shift
        got_pos, got_occ, got_ovf = mt.ops.cuda_shift.shift(
            cfg, torch.from_numpy(pos_in), torch.from_numpy(occ_in),
            torch.from_numpy(axis).to(torch.int32), torch.from_numpy(d))
        assert_bitwise(got_pos, pos_want)
        assert_bitwise(got_occ, occ_want)
        assert bool(got_ovf) == ovf is False
        occ = occ_want
        metrics.append((acc_sweep, prop_sweep))
    print(f"{key}: near-tie cells that differ: {differing}")
    start = mt.state_from_numpy(pos0, occ0, 0, False, device="cpu")
    e0, ov0 = oracle_energy(cfg, pot, start)
    got, m = mt.run_sweeps(cfg, pot, start, n_sweeps,
                           Replay(sweeps, pot.has_energy))
    # The O(N^2) oracle on the run's start and end: no overlap, and the
    # summed dE equals the energy change exactly (square wells: integer
    # energies; hard spheres: 0).
    e1, ov1 = oracle_energy(cfg, pot, got)
    assert not ov0 and not ov1
    assert e1 - e0 == float(m.delta_e.double().sum())
    if differing == 0:
        assert_bitwise(got.pos, pos1)
        assert_bitwise(got.occ, occ1)
        acc, prop = (np.array(v) for v in zip(*metrics))
        np.testing.assert_array_equal(m.accepted.numpy(), acc)
        np.testing.assert_array_equal(m.proposed.numpy(), prop)
    assert bool(got.overflow) == ovf1 is False
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    mt.validate_state(cfg, got, pot)


def _polynomial_substeps():
    """tests/test_pallas.py:89's configuration: LJ shifted at r_cut 2.0
    fitted to degree 6 on 500 samples of mcjax's float32 pair energy, 25
    atoms in 2D, and each color's mcjax ``color_substep`` from the seed-0
    start with key 11: per color (pos in, own out, dE, accepted, proposed,
    pick_u, disp, acc_u), numpy, and the fitted coefficients."""
    lj = jp.LennardJones(epsilon=1.0, sigma=1.0, r_cut=2.0, shift=True)
    r = np.linspace(0.8, 2.0, 500)
    pp = jp.fit_pair_polynomial(r, np.asarray(lj.pair_energy(r * r)),
                                degree=6, r_cut=2.0)
    cfg = JaxConfig(dim=2, n_atoms=25, box_length=10.0, cells_per_side=4,
                    nmax=6, n_moves=2, beta=0.3, step_size=0.3)
    st = jax_init_state(cfg, seed=0)
    k = jax.random.key(11)
    out = []
    for color in range(4):
        # called as that test calls it, not jitted whole: jitted alone, XLA
        # fuses step * z into old + disp (ROADMAP C4), which run_sweeps
        # and the port round apart
        own, de, acc, prop = jsweep.color_substep(cfg, pp, color, st.pos,
                                                  st.occ, k)
        draws = jsweep.substep_randoms(cfg, k, cfg.block_shape)
        out.append((np.array(st.pos), np.array(st.occ), np.array(own),
                    np.array(de), int(acc), int(prop),
                    *(np.array(a) for a in draws)))
    return pp.coeffs, out


def test_polynomial_substeps_match_mcjax(tmp_path_factory):
    """The fitted PolynomialPotential through the port's plain sub-step on
    mcjax's configuration and draws, every color: bit for bit outside
    near-tie cells, dE within DE_REL + DE_ABS where no cell differs."""
    coeffs, subs = shared(tmp_path_factory, "pairs_polynomial",
                          _polynomial_substeps)
    pot = mt.PolynomialPotential(coeffs=coeffs, r_cut=2.0)
    cfg = mt.SimConfig(dim=2, n_atoms=25, box_length=10.0, cells_per_side=4,
                       nmax=6, n_moves=2, beta=0.3, step_size=0.3)
    for color, (pos, occ, own_want, de, na, np_, pick_u, disp,
                acc_u) in enumerate(subs):
        rec = {}
        own, t_de, t_acc, t_prop = cuda_substep.color_substep(
            cfg, pot, color, torch.from_numpy(pos), torch.from_numpy(occ),
            torch.from_numpy(pick_u), torch.from_numpy(disp),
            torch.from_numpy(acc_u), rec)
        differs = (_bits(own.numpy()) != _bits(own_want)).any(axis=(0, 1))
        ties = (rec["margin"] <= NEAR_TIE).numpy()
        assert not (differs & ~ties).any(), color
        assert int(t_prop) == np_
        if not differs.any():
            assert int(t_acc) == na
            assert abs(float(t_de) - float(de)) <= \
                DE_REL * abs(float(de)) + DE_ABS


PORT_MODELS = ["hard", "lj", "sw", "wca", "soft", "yukawa", "morse", "poly"]


@pytest.mark.parametrize("name", PORT_MODELS)
def test_kernel_library_routes_every_pair_model(name):
    """Every pair model has a hand-written kernel in 2D and 3D: 2D hard
    disks the disk kernel, the other 2D models the pair form of the 2D
    kernel (nmax <= 16), 3D LJ the LJ kernel and the other 3D models the
    pair kernel (nmax <= 32); past those capacities it raises. The
    functor's constants are the float32 values of the plain version."""
    pot = port_model(name)
    cfg2 = mt.SimConfig(dim=2, n_atoms=100, box_length=20.0,
                        cells_per_side=6, nmax=16)
    cfg3 = mt.SimConfig(dim=3, n_atoms=100, box_length=20.0,
                        cells_per_side=6, nmax=32)
    want2 = cuda_substep.LIB if name == "hard" else cuda_substep.LIB_PAIR2D
    want3 = cuda_substep.LIB_LJ if name == "lj" else cuda_substep.LIB_PAIR
    assert cuda_substep.kernel_library(cfg2, pot) is want2
    assert cuda_substep.kernel_library(cfg3, pot) is want3
    for cfg in (cfg2.replace(nmax=17), cfg3.replace(nmax=33)):
        with pytest.raises(NotImplementedError, match="nmax"):
            cuda_substep.kernel_library(cfg, pot)
    pp = cuda_substep.pair_params(pot)
    assert pp.model == cuda_substep.PAIR_MODELS[type(pot)]
    assert pp.rc2 == np.float32(pot.r_cut * pot.r_cut)
    core = tp.core_diameter(pot)
    assert pp.core2 == np.float32(core * core)
    if name == "poly":
        assert list(pp.coef[:pp.n]) == [np.float32(c) for c in pot.coeffs]


@pytest.mark.parametrize("form", ["philox", "npt", "field"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pair_kernels_raise_for_left_out_forms(form, dim):
    """The pair kernels have their host-random NVT form only: on a device
    other than the CPU a Philox key, an NPT scale or a field raises
    NotImplementedError (naming the ROADMAP item) before any launch, and
    never falls back to the plain version (meta tensors: no kernel can
    run)."""
    meta = torch.device("meta")
    cfg = mt.SimConfig(dim=dim, n_atoms=100, box_length=20.0,
                       cells_per_side=6, nmax=8)
    pot = mt.SquareWell()
    bs = cfg.block_shape
    pos = torch.empty((cfg.n_colors, dim, cfg.nmax, *bs), device=meta)
    occ = torch.empty((cfg.n_colors, *bs), dtype=torch.int32, device=meta)
    perm = torch.empty((cfg.n_colors,), dtype=torch.int32, device=meta)
    draw = (torch.empty((cfg.n_moves, *bs), device=meta),
            torch.empty((cfg.n_moves, dim, *bs), device=meta),
            torch.empty((cfg.n_moves, *bs), device=meta))
    kw, draws = {}, [draw]
    if form == "philox":
        draws = PhiloxKey(seed=1, sweep=0, ih_k=12)
    elif form == "npt":
        kw["scale"] = torch.ones((), device=meta)
    else:
        kw["field"] = mt.models.fields.LinearField(g=0.1, axis=dim - 1)
    with pytest.raises(NotImplementedError, match="ROADMAP B8"):
        cuda_substep.substeps(cfg, pot, pos, occ, perm, draws, **kw)
