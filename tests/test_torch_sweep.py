"""The port's sweep held bit for bit against mcjax.ops.sweep.run_sweeps.

2D hard disks. The port draws its random numbers through a provider that
evaluates mcjax's own Threefry key tree, so both engines see the same
numbers: positions, occupancies, accept and propose counts and the overflow
flag must then be equal bit for bit. Three jitted mcjax functions serve the
whole file: the per-sweep random draws, one sweep with its intermediate
states exposed, and run_sweeps itself. Their results are built once per
pytest run and shared between xdist workers (``shared_reference``), as
numpy arrays, in two references that two workers can build side by side:
the run, and the draws of every sweep the tests replay with the sweep's
steps.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.core.state import SimState as JaxState
from mcjax.core.state import init_state as jax_init_state
from mcjax.models.mixtures import kob_andersen as jax_kob_andersen
from mcjax.models.potentials import HardSphere as JaxHardSphere
from mcjax.ops import cells as jcells
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch.ops import cuda_shift, cuda_substep
from shared_reference import shared

N = 2048
N_SWEEPS = 3
# hard disks of diameter 1 at phi 0.5 in cells about two diameters wide, the
# geometry of bench.py
BOX = math.sqrt(N * math.pi / 4 / 0.5)
CPS = int(BOX // 2) - int(BOX // 2) % 2
KW = dict(dim=2, n_atoms=N, box_length=BOX,
          cells_per_side=CPS, nmax=7, n_moves=16,
          proposal="uniform", step_size=0.18, beta=1.0, seed=0)
JCFG = JaxConfig(**KW)
CFG = mt.SimConfig(**KW)
JPOT = JaxHardSphere(1.0)
POT = mt.HardSphere(1.0)


def _schedule_keys(key, sweep):
    """mcjax.ops.sweep.mc_sweep's key tree for one sweep."""
    k_perm, k_axis, k_dist, k_sub = jax.random.split(
        jax.random.fold_in(key, sweep), 4)
    perm = jax.random.permutation(k_perm, JCFG.n_colors)
    axis = jax.random.randint(k_axis, (), 0, JCFG.dim)
    half_w = JCFG.cell_width / 2.0
    d = jax.random.uniform(k_dist, (), minval=-half_w, maxval=half_w)
    return perm, axis, d, k_sub


def _sweep_randoms(key, sweep):
    perm, axis, d, k_sub = _schedule_keys(key, sweep)
    subs = [jsweep.substep_randoms(JCFG, jax.random.fold_in(k_sub, i),
                                   JCFG.block_shape, need_acc=False)
            for i in range(JCFG.n_colors)]
    return (perm, axis, d, jnp.stack([s[0] for s in subs]),
            jnp.stack([s[1] for s in subs]))


def _sweep_steps(perm, pos, occ, key, sweep):
    """One mc_sweep with every sub-step's state and counts exposed; the
    color order ``perm`` (static) is the one the key tree draws."""
    _, axis, d, k_sub = _schedule_keys(key, sweep)
    steps, accs, props = [], [], []
    for i, color in enumerate(perm):
        own, _, na, np_ = jsweep.color_substep(
            JCFG, JPOT, color, pos, occ, jax.random.fold_in(k_sub, i))
        pos = pos.at[color].set(own)
        steps.append(pos)
        accs.append(na)
        props.append(np_)
    shifted = jcells.shift_rebin(JCFG, pos, occ, axis, d)
    return jnp.stack(steps), jnp.stack(accs), jnp.stack(props), shifted


class MCJaxRandoms:
    """Provider that hands the port mcjax's own random numbers: ``draws``
    maps each sweep to ``_sweep_randoms``' arrays (numpy)."""

    def __init__(self, draws):
        self.draws = draws

    def _draw(self, sweep):
        return [torch.from_numpy(a) for a in self.draws[int(sweep)]]

    def schedule(self, cfg, sweep):
        perm, axis, d, _, _ = self._draw(sweep)
        return perm.to(torch.int32), axis.to(torch.int32), d

    def substep(self, cfg, sweep, i, need_acc):
        assert not need_acc
        _, _, _, pick_u, disp = self._draw(sweep)
        return pick_u[i].contiguous(), disp[i].contiguous(), None


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run():
    st0 = jax_init_state(JCFG)
    return (st0,) + jsweep.run_sweeps(JCFG, JPOT, st0, N_SWEEPS)


def _state(st: JaxState) -> dict:
    return dict(pos=np.array(st.pos), occ=np.array(st.occ),
                sweep=int(st.sweep), overflow=bool(st.overflow))


def _run_reference() -> dict:
    """mcjax's run: initial and final state and metrics (numpy only, so
    the workers can share it)."""
    st0, st, m = jax.jit(_jax_run)()
    return dict(st0=_state(st0), st=_state(st),
                m=jax.tree_util.tree_map(np.array, m))


def _steps_reference() -> dict:
    """The draws of sweeps 0 to N_SWEEPS, and one more mcjax sweep, step
    by step (``_sweep_steps``), from the state after N_SWEEPS sweeps: the
    port's run on mcjax's draws, which ``test_run_sweeps_bitwise`` holds
    equal to mcjax's ``run_sweeps`` bit for bit (so this reference needs
    no run_sweeps compile of its own, and builds beside ``_run_reference``
    on another worker)."""
    st0 = jax_init_state(JCFG)
    randoms_fn = jax.jit(_sweep_randoms)
    draws = {sweep: [np.array(a) for a in randoms_fn(st0.key,
                                                     jnp.int32(sweep))]
             for sweep in range(N_SWEEPS + 1)}
    st, _ = mt.run_sweeps(CFG, POT, to_torch(SimpleNamespace(**_state(st0))),
                          N_SWEEPS, MCJaxRandoms(draws))
    end = dict(pos=st.pos.numpy(), occ=st.occ.numpy(), sweep=st.sweep,
               overflow=bool(st.overflow))
    perm = tuple(int(c) for c in draws[N_SWEEPS][0])
    out = jax.jit(_sweep_steps, static_argnums=0)(
        perm, jnp.asarray(end["pos"]), jnp.asarray(end["occ"]), st0.key,
        jnp.int32(N_SWEEPS))
    return dict(draws=draws, st=end, perm=np.array(perm),
                steps=jax.tree_util.tree_map(np.array, out))


@pytest.fixture(scope="module")
def run_reference(tmp_path_factory):
    return shared(tmp_path_factory, "torch_sweep_run", _run_reference)


@pytest.fixture(scope="module")
def steps_reference(tmp_path_factory):
    return shared(tmp_path_factory, "torch_sweep_steps", _steps_reference)


@pytest.fixture(scope="module")
def jax_run(run_reference):
    """(initial mcjax state, state after N_SWEEPS sweeps, metrics)."""
    return (SimpleNamespace(**run_reference["st0"]),
            SimpleNamespace(**run_reference["st"]), run_reference["m"])


@pytest.fixture(scope="module")
def randoms_fn(steps_reference):
    """mcjax's draws of every sweep the tests replay."""
    return steps_reference["draws"]


def to_torch(st) -> mt.SimState:
    return mt.state_from_numpy(np.asarray(st.pos), np.asarray(st.occ),
                               st.sweep, st.overflow, device="cpu")


def assert_bitwise(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_run_sweeps_bitwise(jax_run, randoms_fn):
    st0, st, m = jax_run
    got, gm = mt.run_sweeps(CFG, POT, to_torch(st0), N_SWEEPS,
                            MCJaxRandoms(randoms_fn))
    assert got.sweep == N_SWEEPS
    assert_bitwise(got.pos, st.pos)
    assert_bitwise(got.occ, st.occ)
    np.testing.assert_array_equal(gm.accepted.numpy(), m.accepted)
    np.testing.assert_array_equal(gm.proposed.numpy(), m.proposed)
    np.testing.assert_array_equal(gm.overflow.numpy(), m.overflow)
    assert bool(got.overflow) == bool(st.overflow) is False
    assert 0 < gm.accepted.sum() < gm.proposed.sum()
    mt.validate_state(CFG, got, POT)


@pytest.fixture(scope="module")
def steps(steps_reference):
    """One more mcjax sweep from the state after N_SWEEPS sweeps, step by
    step."""
    r = steps_reference
    return SimpleNamespace(**r["st"]), r["perm"], r["steps"]


@pytest.mark.parametrize("i", range(4))
def test_color_substep_bitwise(steps, randoms_fn, i):
    """Sub-step i (color perm[i]) of a sweep, through the wrapper's plain
    path; the earlier sub-steps of the sweep run first."""
    st, perm, (pos_steps, accs, props, _) = steps
    tst = to_torch(st)
    provider = MCJaxRandoms(randoms_fn)
    t_perm, _, _ = provider.schedule(CFG, tst.sweep)
    np.testing.assert_array_equal(t_perm.numpy(), perm)
    for j in range(i + 1):
        pick_u, disp, _ = provider.substep(CFG, tst.sweep, j, False)
        de, acc, prop = cuda_substep.substep(CFG, POT, tst.pos, tst.occ,
                                             t_perm, j, pick_u, disp)
    assert_bitwise(tst.pos, pos_steps[i])
    assert int(acc) == int(accs[i]) and int(prop) == int(props[i])
    assert 0 < int(acc) < int(prop) and float(de) == 0.0


def test_sweep_shift_bitwise(steps, randoms_fn):
    st, _, (pos_steps, _, _, (s_pos, s_occ, s_ovf)) = steps
    provider = MCJaxRandoms(randoms_fn)
    _, axis, d = provider.schedule(CFG, int(st.sweep))
    got_pos, got_occ, got_ovf = cuda_shift.shift(
        CFG, torch.from_numpy(pos_steps[-1]), torch.from_numpy(
            np.array(st.occ)), axis, d)
    assert_bitwise(got_pos, s_pos)
    assert_bitwise(got_occ, s_occ)
    assert bool(got_ovf) == bool(s_ovf) is False


BIG = mt.SimConfig(**{**KW, "n_atoms": 1 << 20,
                      "box_length": math.sqrt((1 << 20) * math.pi / 2),
                      "cells_per_side": 640})


def _field_site(site):
    """(mcjax's result, the port's, the result with every product rounded
    apart, or None where the site has no product) of an external-field
    expression, compiled as the sub-steps compile it: the trap's per-axis
    sum, g * x in a move's dE (with a pair energy, and without one, whose
    zero XLA folds), a species coupling times an energy in a mixture move's
    dE, and the physical wrap at the 1M lj3d box with origins near +-L/2."""
    from mcjax.core.geometry import wrap_into_box as jax_wrap
    from mcjax.models import fields as jf

    from mcjax_torch.core.geometry import wrap_into_box
    from mcjax_torch.models import fields as tf

    rng = np.random.default_rng(13)
    n = 1 << 16
    xo = rng.uniform(-50.0, 50.0, (3, n)).astype(np.float32)
    xn = (xo + rng.uniform(-0.3, 0.3, (3, n))).astype(np.float32)
    de = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    s = rng.integers(0, 2, n).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xo, xn, de, s)]
    f32 = np.float32
    if site == "trap_sum":
        k = (0.3, 0.7, 1.3)
        want = jax.jit(jf.HarmonicTrap(stiffness=k, dim=3).energy)(xo)
        got = tf.HarmonicTrap(stiffness=k, dim=3).energy(t[0])
        terms = [f32(0.5 * kk) * xo[a] * xo[a] for a, kk in enumerate(k)]
        return want, got, terms[0] + terms[1] + terms[2]
    if site == "gravity_de":
        jg, g = jf.LinearField(g=0.1, axis=2), f32(0.1)
        want = jax.jit(lambda d, a, b: d + jg.energy(b) - jg.energy(a))(
            de, xo, xn)
        want0 = jax.jit(lambda a, b: 0.0 + jg.energy(b) - jg.energy(a))(
            xo, xn)
        tg = tf.LinearField(g=0.1, axis=2)
        got = tf.field_delta(tg, t[2], t[1], t[0])
        got0 = tf.field_delta(tg, None, t[1], t[0])
        np.testing.assert_array_equal(got0.numpy().view(np.uint32),
                                      np.asarray(want0).view(np.uint32))
        return want, got, (de + g * xn[2]) - g * xo[2]
    if site == "species_de":
        jsp = jf.SpeciesField(jf.LinearField(g=1.0, axis=2), (0.1, 0.05))
        want = jax.jit(lambda d, a, b, s: d + (
            jf.species_energy(jsp, b, s) - jf.species_energy(jsp, a, s)))(
            de, xo, xn, s)
        got = tf.field_delta(tf.SpeciesField(tf.LinearField(g=1.0, axis=2),
                                             (0.1, 0.05)),
                             t[2], t[1], t[0], t[3])
        c = np.where(s == 0, f32(0.1), f32(0.05))
        return want, got, de + (c * xn[2] - c * xo[2])
    box = (1_000_000 / 0.8) ** (1.0 / 3.0)
    org = np.array([box / 2 - 1e-3, -box / 2, 0.37], np.float32)
    want = jax.jit(lambda a, o: jax_wrap(a + o[:, None], box))(xn, org)
    got = wrap_into_box(t[1] + torch.from_numpy(org)[:, None], box)
    return want, got, None


@pytest.mark.parametrize("site", ["r2_own", "r2_nbr", "lower_bound",
                                  "r2_own_3d", "r2_nbr_3d", "mixture_nbr_3d",
                                  "trap_sum", "gravity_de", "species_de",
                                  "physical_wrap"])
def test_contraction_sites_match_xla(site):
    """The places where XLA on the CPU fuses a multiply into an add (squared
    distance in 2D and 3D, cell lower bound) and the port's fma_f32 agree
    bit for bit, on data where rounding the products separately differs.
    (The Lennard-Jones bracket's site is held by
    test_torch_lj3d.py::test_lj_pair_energy_bitwise.) ``mixture_nbr_3d``
    composes the 3D squared distance with the Kob-Andersen pair energy, as
    the mixture sub-step does, compiled as one function: the contractions
    stay where the port puts them when the two meet. The external-field
    sites (``_field_site``) are the ones the sub-step kernels' field forms
    write out as fmas (csrc/field.cuh)."""
    if site in ("trap_sum", "gravity_de", "species_de", "physical_wrap"):
        want, got, separate = _field_site(site)
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        if separate is not None:
            assert np.count_nonzero(separate != want) > 0.01 * want.size
        return
    if site == "mixture_nbr_3d":
        rng = np.random.default_rng(12)
        shape = (26, 3, 34, 4, 4, 4)
        d = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
        si = np.float32(rng.integers(0, 2, shape[2:]))[None]
        sj = np.float32(rng.integers(0, 2, (26,) + shape[2:]))
        want = np.asarray(jax.jit(
            lambda x, a, b: jax_kob_andersen().pair_energy_s(
                jnp.sum(x * x, axis=1), a, b))(d, si, sj))
        ka = mt.kob_andersen()
        td, tsi, tsj = (torch.from_numpy(a) for a in (d, si, sj))
        got = ka.pair_energy_s(cuda_substep.squared_norm(td, 1), tsi,
                               tsj).numpy()
        sq = td * td
        separate = ka.pair_energy_s(sq[:, 0] + sq[:, 1] + sq[:, 2], tsi,
                                    tsj).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert np.count_nonzero(separate != want) > 0.01 * want.size
        return
    if site == "lower_bound":
        # mcjax/ops/sweep.py:74 at the 1M geometry, the cell index traced
        # (a constant index lets XLA fold the bounds without contracting)
        w, half = BIG.cell_width, BIG.box_length / 2.0
        ck = np.stack([np.stack([2 * np.indices(BIG.block_shape)[k]
                                 + ((c >> k) & 1) for k in range(2)])
                       for c in range(4)]).astype(np.int32)
        want = np.asarray(jax.jit(
            lambda c: c.astype(jnp.float32) * w - half)(ck))
        got = torch.stack([cuda_substep.cell_lower_bounds(
            BIG, c, BIG.block_shape, torch.device("cpu"))
            for c in range(4)]).numpy()
        separate = ck.astype(np.float32) * np.float32(w) - np.float32(half)
    else:
        # the shapes of the sub-step's own-cell and neighbor differences
        shape, axis = {"r2_own": ((2, 7, 64, 64), 0),
                       "r2_nbr": ((8, 2, 7, 64, 64), 1),
                       "r2_own_3d": ((3, 24, 8, 8, 8), 0),
                       "r2_nbr_3d": ((26, 3, 24, 8, 8, 8), 1)}[site]
        d = np.random.default_rng(11).uniform(-2.0, 2.0, shape).astype(
            np.float32)
        want = np.asarray(jax.jit(lambda x: jnp.sum(x * x, axis=axis))(d))
        got = cuda_substep.squared_norm(torch.from_numpy(d), axis).numpy()
        sq = d * d
        separate = sq.take(0, axis) + sq.take(1, axis)
        if shape[axis] == 3:
            separate = separate + sq.take(2, axis)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.count_nonzero(separate != want) > 0.01 * want.size
