"""External one-body fields: the port held against mcjax on the CPU.

The field models (``mcjax_torch.models.fields``), the sub-steps under a
field (``cuda_substep.color_substep`` and ``mixture.color_substep_mixture``
with ``field`` / ``origin``) and the field drivers (``ops/extfield.py``)
against mcjax's XLA field engine (``mcjax.models.fields``,
``color_substep(field=)``, ``color_substep_mixture(field=)``,
``extfield.run_field_sweeps``), which mcjax's own
tests/test_extfield_pallas.py locks to its Pallas field kernels bit for
bit. Inputs are made from seeds with numpy, or are mcjax's own setups
(binned by the port, whose binning tests/test_torch_cells.py holds to
mcjax's, so that no eager mcjax binning is compiled); the port is fed
mcjax's random numbers. mcjax is jitted three times: the confined run's
scan, the trap's sub-steps, and the mixture's sub-steps (one compile for
both mixture cases), besides one small jit each for the field models and
the field totals.

Gates, with their tolerances:
* field energies and forbidden masks bit for bit, with coordinates 1-4
  ulps either side of every wall bound (one bound pair, and one a
  species);
* hard disks under walls, and under a trap (mcjax's setups): every color
  sub-step bit for bit in positions and counts; for the trap, dE within
  DE_REL / DE_ABS (mcjax's own bound), and a cell may differ only where a
  decision came within NEAR_TIE of a tie (torch's exp against XLA's; the
  count is printed, 0 expected);
* a confined hard-disk run, 8 sweeps: positions, occupancies, the frame
  origin and accept counts bit for bit, and no particle in the walls;
* a trap composed with per-species wall margins over a 2D LJ mixture,
  from the starts of mcjax's tests/test_extfield.py:151 and :220: every
  sub-step bit for bit outside the tie band, dE within DE_REL;
* the energy anchor of a trapped LJ run: summed dE against the change of
  pair + field totals within mcjax's bound, 1e-2 (relative);
* ``physical_positions`` bit for bit, ``total_field_energy_cells`` within
  TOTAL_REL; ``field_from_spec`` round-trips.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.core.state import SimState as JaxState
from mcjax.models import fields as jf
from mcjax.models.mixtures import LJMixture as JaxLJMixture
from mcjax.models.potentials import HardSphere as JaxHardSphere
from mcjax.ops import extfield as jext
from mcjax.ops import mixture as jmix
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch import convert
from mcjax_torch.models import fields as tf
from mcjax_torch.ops import cuda_substep, extfield, mixture
from shared_reference import shared

NEAR_TIE = 1e-5
DE_REL, DE_ABS = 1e-5, 1e-6
ANCHOR_REL = 1e-2
TOTAL_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def port(field):
    """The port's twin of an mcjax field, carried across as a spec."""
    return convert.field_from_spec(convert.field_to_spec(field))


def to_torch(st):
    return mt.state_from_numpy(np.asarray(st.pos), np.asarray(st.occ),
                               st.sweep, st.overflow, device="cpu")


# ---- field models --------------------------------------------------------

FIELDS = {
    "trap2": (2, jf.HarmonicTrap(stiffness=(0.3, 1.7), dim=2)),
    "trap3_center": (3, jf.HarmonicTrap(stiffness=(0.3, 0.7, 1.3),
                                        center=(0.1, -0.2, 0.3), dim=3)),
    "linear": (3, jf.LinearField(g=0.37, axis=2)),
    "linear_g1": (2, jf.LinearField(g=1.0, axis=0)),
    "walls": (3, jf.SlitWalls(lo=-4.15, hi=3.85, axis=1, diameter=1.1)),
    "walls_species": (2, jf.SlitWalls(lo=-4.15, hi=3.85, axis=1,
                                      diameters=(1.1, 0.7))),
    "species_gravity": (3, jf.SpeciesField(jf.LinearField(g=1.0, axis=2),
                                           (0.1, 0.05))),
    "species_trap": (2, jf.SpeciesField(jf.HarmonicTrap(0.4, dim=2),
                                        (0.7, 1.9))),
    "sedimentation": (3, jf.CompositeField((
        jf.LinearField(g=0.1, axis=2),
        jf.SlitWalls(lo=-4.15, hi=3.85, axis=2, diameter=1.0)))),
    "trap_gravity_walls": (2, jf.CompositeField((
        jf.HarmonicTrap(stiffness=(0.5, 0.0), dim=2),
        jf.LinearField(g=-0.21, axis=1),
        jf.SlitWalls(lo=-4.15, hi=3.85, axis=1, diameter=1.0)))),
    "fractionation": (3, jf.CompositeField((
        jf.SpeciesField(jf.LinearField(g=1.0, axis=2), (0.1, 0.05)),
        jf.SlitWalls(lo=-4.15, hi=3.85, axis=2, diameters=(1.0, 0.8))))),
    "species_trap_gravity": (3, jf.CompositeField((
        jf.SpeciesField(jf.HarmonicTrap(0.4, dim=3), (0.7, 1.9)),
        jf.LinearField(g=0.3, axis=0),
        jf.SlitWalls(lo=-4.15, hi=3.85, axis=0, diameters=(1.0, 0.8))))),
}


def _walls(field):
    if isinstance(field, jf.CompositeField):
        return [w for f in field.fields for w in _walls(f)]
    return [field] if isinstance(field, jf.SlitWalls) else []


def _field_inputs(dim, field, seed):
    """Random physical coordinates [dim, n] and species [n], with the wall
    axis set 1-4 ulps either side of each bound a species sees."""
    rng = np.random.default_rng(seed)
    n = 4096
    x = rng.uniform(-6.0, 6.0, (dim, n)).astype(np.float32)
    s = rng.integers(0, 2, n).astype(np.float32)
    at = 0
    for w in _walls(field):
        for k, dia in enumerate(w.diameters or (w.diameter, w.diameter)):
            if w.diameters:    # f32(lo) + h, as forbidden_s rounds it
                h = np.float32(0.5) * np.float32(dia)
                bounds = (np.float32(w.lo) + h, np.float32(w.hi) - h)
            else:
                bounds = (np.float32(w.lo + 0.5 * dia),
                          np.float32(w.hi - 0.5 * dia))
            for b in bounds:
                for ulps in (-4, -3, -2, -1, 0, 1, 2, 3, 4):
                    v = b
                    step = np.float32(np.inf if ulps > 0 else -np.inf)
                    for _ in range(abs(ulps)):
                        v = np.nextafter(v, step, dtype=np.float32)
                    x[w.axis, at] = v
                    s[at] = k
                    at += 1
    return x, s


def _species_resolved(name):
    jfield = FIELDS[name][1]
    return "species" in name or name == "fractionation" or \
        bool(getattr(jfield, "diameters", ()))


@functools.lru_cache(maxsize=None)
def _field_references():
    """Every field's inputs and mcjax's energies and forbidden masks on
    them, out of one jitted function (one compile for all fields)."""
    inputs = {name: _field_inputs(dim, jfield, seed=len(name))
              for name, (dim, jfield) in FIELDS.items()}

    def ref(inputs):
        out = {}
        for name, (x, s) in inputs.items():
            jfield = FIELDS[name][1]
            sp = s if _species_resolved(name) else None
            e = jf.species_energy(jfield, x, sp) if jfield.has_energy \
                else None
            out[name] = (e, jf.species_forbidden(jfield, x, sp))
        return out

    return inputs, jax.jit(ref)(inputs)


@pytest.mark.parametrize("g", [0.1, 1.0])
def test_shared_linear_product_gap(g):
    """ROADMAP C9: a ``LinearField`` both bare and inside a
    ``SpeciesField`` of one ``CompositeField``. XLA computes the product
    p = f32(g x) once for both and folds the species product instead:
    E = fma(c_s, p, p) (held here bit for bit against mcjax). The port, as
    its kernels' field form (csrc/field.cuh), folds the bare product:
    fma(g, x, f32(c_s p)). The gap is kept, and held to its measured size:
    at g = 0.1 the energies differ in about a quarter of the cases (15,083
    of 65,536), each by at most one float32 ulp, and a mixture move's dE
    by at most 2 ulps of the largest of the two energies and dE; at g = 1
    there is no product to fold and both are bit for bit."""
    rng = np.random.default_rng(3)
    n = 1 << 16
    x = rng.uniform(-50, 50, (3, n)).astype(np.float32)
    xn = (x + rng.uniform(-0.3, 0.3, (3, n))).astype(np.float32)
    s = rng.integers(0, 2, n).astype(np.float32)
    de = rng.uniform(-3, 3, n).astype(np.float32)
    jfield = jf.CompositeField((jf.LinearField(g=g, axis=2), jf.SpeciesField(
        jf.LinearField(g=g, axis=2), (0.3, 0.05))))
    tfield = port(jfield)
    t = [torch.from_numpy(a) for a in (x, xn, s, de)]
    want = np.asarray(jax.jit(lambda a, b: jf.species_energy(jfield, a, b))(
        x, s))
    got = tf.species_energy(tfield, t[0], t[2]).numpy()
    c = np.where(s == 0, np.float32(0.3), np.float32(0.05))
    p = np.float32(g) * x[2]
    shared_form = tf.fma_f32(torch.from_numpy(c), torch.from_numpy(p),
                             torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(_bits(shared_form), _bits(want))
    want_de = np.asarray(jax.jit(lambda d, a, b, s_: d + (
        jf.species_energy(jfield, b, s_) - jf.species_energy(jfield, a, s_)))(
        de, x, xn, s))
    got_de = tf.field_delta(tfield, t[3], t[1], t[0], t[2]).numpy()
    if g == 1.0:
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got_de), _bits(want_de))
        return
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    print(f"g {g}: {np.count_nonzero(ulps)} of {n} energies differ, by at "
          f"most {ulps.max()} ulp")
    assert 0.1 * n < np.count_nonzero(ulps) < 0.4 * n and ulps.max() == 1
    e_max = np.maximum(np.abs(want), np.abs(np.asarray(
        jax.jit(lambda a, b: jf.species_energy(jfield, a, b))(xn, s))))
    gap = np.abs(got_de.astype(np.float64) - want_de) / np.spacing(
        np.maximum(e_max, np.abs(want_de)))
    print(f"g {g}: dE differs in {np.count_nonzero(gap)} cases, by at most "
          f"{gap.max()} ulps of the largest of the energies and dE")
    assert gap.max() <= 2


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_models_bitwise(name):
    """Energies (species-resolved where the field is) and forbidden masks
    of the port's field equal mcjax's jitted ones bit for bit."""
    jfield = FIELDS[name][1]
    species = _species_resolved(name)
    inputs, refs = _field_references()
    (x, s), (want_e, want_bad) = inputs[name], refs[name]
    field = port(jfield)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    sp = ts if species else None
    if jfield.has_energy:
        got_e = tf.species_energy(field, tx, sp).numpy()
        np.testing.assert_array_equal(_bits(got_e), _bits(want_e))
    got_bad = tf.species_forbidden(field, tx, sp).numpy()
    np.testing.assert_array_equal(got_bad, np.asarray(want_bad))
    if _walls(jfield):
        assert 0 < got_bad.sum() < got_bad.size


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_field_from_spec_round_trips(name):
    _, jfield = FIELDS[name]
    spec = convert.field_to_spec(jfield)
    field = convert.field_from_spec(spec)
    assert type(field).__name__ == type(jfield).__name__
    assert convert.field_to_spec(field) == spec
    assert convert.field_from_spec(spec) == field and hash(field)


def test_species_field_needs_a_mixture():
    field = port(FIELDS["species_gravity"][1])
    with pytest.raises(TypeError, match="species-resolved"):
        field.energy(torch.zeros(3, 4))
    with pytest.raises(TypeError, match="species-resolved"):
        cuda_substep.field_params(field, 3, resolved=False)


# ---- hard disks ------------------------------------------------------------

def _jax_state(kw, st):
    """mcjax's state holding a port state's slots, with the key mcjax's
    ``init_state`` gives it."""
    return JaxState(pos=jnp.asarray(st.pos.numpy()),
                    occ=jnp.asarray(st.occ.numpy()),
                    key=jax.random.key(JaxConfig(**kw).seed),
                    sweep=jnp.zeros((), jnp.int32),
                    overflow=jnp.asarray(bool(st.overflow)))


@functools.lru_cache(maxsize=None)
def _slit_setup(seed=0, n=48, L=12.0):
    """tests/test_extfield_pallas.py::_slit_setup's disks, binned by the
    port's ``init_state`` (held to mcjax's binning in test_torch_cells.py),
    which compiles nothing; cached, as several tests share a seed."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.9, 2.9, n),
                    rng.uniform(-L / 2, L / 2, n)], axis=1)
    keep = []
    for i in range(n):
        d = pts[keep] - pts[i] if keep else np.empty((0, 2))
        d -= L * np.round(d / L)
        if keep and (np.sum(d * d, 1) < 1.0).any():
            continue
        keep.append(i)
    pts = pts[keep]
    kw = dict(dim=2, n_atoms=len(pts), box_length=L, cells_per_side=4,
              nmax=10, n_moves=4, proposal="uniform", step_size=0.3,
              beta=1.0)
    st = mt.init_state(mt.SimConfig(**kw), "cpu",
                       torch.from_numpy(pts.astype(np.float32)))
    return kw, _jax_state(kw, st)


WALLS = jf.SlitWalls(lo=-3.5, hi=3.5, axis=0, diameter=1.0)
# tests/test_extfield_pallas.py:64's field: a trap over hard disks
TRAP = jf.HarmonicTrap(stiffness=0.3, dim=2)


def _check_cells(got_pos, want_pos, margin):
    """Cells whose slots differ; each must have come within NEAR_TIE of a
    tie. Returns their count."""
    diff = (_bits(got_pos) != _bits(want_pos)).any(axis=(0, 1))
    if margin is None:
        assert not diff.any()
        return 0
    assert (margin.numpy()[diff] < NEAR_TIE).all()
    return int(diff.sum())


RUN_SWEEPS = 8


def _np_state(st) -> SimpleNamespace:
    return SimpleNamespace(pos=np.array(st.pos), occ=np.array(st.occ),
                           sweep=int(st.sweep), overflow=bool(st.overflow))


@pytest.fixture(scope="module")
def confined_run(tmp_path_factory):
    """``_confined_run``, built once per run and shared by the workers."""
    return shared(tmp_path_factory, "torch_field_confined_run",
                  _confined_run)


def _confined_run():
    """tests/test_extfield_pallas.py:84: mcjax's 8-sweep walled run of hard
    disks from origin 0, as ``run_field_sweeps`` runs it (a scan of
    ``field_sweep``), with every color sub-step's inputs, draws and
    outputs and every sweep's schedule reported out of the one compile
    (numpy only)."""
    kw, st = _slit_setup(seed=1)
    cfg, pot = JaxConfig(**kw), JaxHardSphere(1.0)
    log = []

    def logged(cfg_, pot_, color, pos, occ, k, shift_fn, beta, offset,
               field=None, origin=None):
        out = jsweep.color_substep(cfg_, pot_, color, pos, occ, k, shift_fn,
                                   beta, offset, field=field, origin=origin)
        pick_u, disp, _ = jsweep.substep_randoms(cfg_, k, cfg_.block_shape,
                                                 need_acc=False)
        jax.debug.callback(
            lambda *a: log.append((color,) + tuple(np.array(x) for x in a)),
            pos, occ, origin, pick_u, disp, *out, ordered=True)
        return out

    def run(st, org):
        def body(carry, _):
            s, o = carry
            k_perm, k_axis, k_dist, _ = jax.random.split(
                jax.random.fold_in(s.key, s.sweep), 4)
            half_w = cfg.cell_width / 2.0
            sched = (jax.random.permutation(k_perm, cfg.n_colors),
                     jax.random.randint(k_axis, (), 0, cfg.dim),
                     jax.random.uniform(k_dist, (), minval=-half_w,
                                        maxval=half_w))
            s, o, m = jext.field_sweep(cfg, pot, WALLS, s, o,
                                       base_substep=logged)
            return (s, o), (m, sched)
        return jax.lax.scan(body, (st, org), length=RUN_SWEEPS)

    (end, org), (m, sched) = jax.jit(run)(st, jnp.zeros(2, jnp.float32))
    sched = jax.tree_util.tree_map(np.array, sched)
    jax.effects_barrier()
    n_colors = cfg.n_colors
    subs = [log[i * n_colors:(i + 1) * n_colors] for i in range(RUN_SWEEPS)]
    return kw, _np_state(st), sched, subs, (_np_state(end), np.array(org),
                                            np.array(m.accepted))


@pytest.fixture(scope="module")
def trap_substeps():
    """tests/test_extfield_pallas.py:64: TRAP over hard disks at origin
    (0.4, 0.9); mcjax's sub-step of each color from the start, and the
    draws (one key for all colors)."""
    kw, st = _slit_setup(seed=3)
    cfg = JaxConfig(**kw)
    org, k = np.float32([0.4, 0.9]), jax.random.key(5)

    def run(pos, occ):
        return (jsweep.substep_randoms(cfg, k, cfg.block_shape,
                                       need_acc=True),
                [jsweep.color_substep(cfg, JaxHardSphere(1.0), c, pos, occ,
                                      k, field=TRAP, origin=jnp.asarray(org))
                 for c in range(cfg.n_colors)])

    draws, subs = jax.tree_util.tree_map(np.array,
                                         jax.jit(run)(st.pos, st.occ))
    return kw, st, org, draws, subs


def test_trap_substeps_match_mcjax(trap_substeps):
    """Energetic field over a hard-core model: the plain sub-step takes the
    acceptance uniforms and the exp test with the field's dE alone."""
    kw, st, org, draws, subs = trap_substeps
    cfg, field = mt.SimConfig(**kw), port(TRAP)
    tst = to_torch(st)
    pick_u, disp, acc_u = (torch.from_numpy(a) for a in draws)
    ties = 0
    for color, (own, de, acc, prop) in enumerate(subs):
        rec = {}
        got, t_de, t_acc, t_prop = cuda_substep.color_substep(
            cfg, mt.HardSphere(1.0), color, tst.pos, tst.occ, pick_u, disp,
            acc_u, rec, field=field, origin=torch.from_numpy(org))
        n = _check_cells(got, own, rec["margin"])
        ties += n
        np.testing.assert_allclose(float(t_de), float(de), rtol=DE_REL,
                                   atol=DE_ABS)
        if not n:
            assert int(t_acc) == int(acc) and int(t_prop) == int(prop)
    assert sum(int(s[2]) for s in subs) < sum(int(s[3]) for s in subs)
    print(f"trap over hard disks: {ties} cells decided within {NEAR_TIE} "
          "of a tie")


def test_walls_substeps_match_mcjax(confined_run):
    """Forbidden-only walls over hard disks: every color sub-step of the
    run (frame origins nonzero from the second sweep on) bit for bit."""
    kw, _, _, subs, _ = confined_run
    cfg, field = mt.SimConfig(**kw), port(WALLS)
    moved = 0
    for sweep in subs:
        for color, pos, occ, org, pick_u, disp, own, de, acc, prop in sweep:
            got, t_de, t_acc, t_prop = cuda_substep.color_substep(
                cfg, mt.HardSphere(1.0), color, torch.from_numpy(pos),
                torch.from_numpy(occ), torch.from_numpy(pick_u),
                torch.from_numpy(disp), field=field,
                origin=torch.from_numpy(org))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(own))
            assert (int(t_acc), int(t_prop)) == (int(acc), int(prop))
            assert float(t_de) == float(de) == 0.0
            moved += int(np.abs(org).sum() > 0)
    assert moved > 0


class Replay:
    """Provider that hands the port the run's schedule and draws."""

    def __init__(self, sched, subs):
        self.sched, self.subs = sched, subs

    def schedule(self, cfg, sweep):
        perm, axis, d = (a[sweep] for a in self.sched)
        return (torch.from_numpy(perm).to(torch.int32),
                torch.tensor(int(axis), dtype=torch.int32),
                torch.from_numpy(np.array(d)))

    def substep(self, cfg, sweep, i, need_acc):
        assert not need_acc
        pick_u, disp = self.subs[sweep][i][4:6]
        return torch.from_numpy(pick_u), torch.from_numpy(disp), None


def test_confined_run_matches_mcjax(confined_run):
    kw, st, sched, subs, (end, org, accepted) = confined_run
    cfg, field = mt.SimConfig(**kw), port(WALLS)
    origin = convert.origin_from_numpy(np.zeros(2, np.float32), "cpu")
    got, t_org, m = extfield.run_field_sweeps(
        cfg, mt.HardSphere(1.0), field, to_torch(st), origin, RUN_SWEEPS,
        Replay(sched, subs))
    np.testing.assert_array_equal(_bits(got.pos.numpy()), _bits(end.pos))
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(end.occ))
    np.testing.assert_array_equal(_bits(t_org.numpy()), _bits(org))
    np.testing.assert_array_equal(m.accepted.numpy(), accepted)
    assert not bool(got.overflow) and float(np.abs(org).sum()) > 0
    assert int(extfield.field_violations(cfg, field, got.pos, got.occ,
                                         t_org)) == 0
    assert float(m.delta_e.abs().sum()) == 0.0


def test_physical_positions_and_field_totals():
    """On a walled start (tests/test_extfield_pallas.py:84's) in a frame
    moved off 0: the physical coordinates bit for bit and the field totals
    (float32 and float64) within TOTAL_REL of mcjax's; violations as mcjax
    counts them."""
    kw, end = _slit_setup(seed=1)
    org = np.float32([0.7, -2.3])
    cfg, jcfg = mt.SimConfig(**kw), JaxConfig(**kw)
    jfield = jf.CompositeField((jf.HarmonicTrap(stiffness=(0.3, 0.6), dim=2),
                                jf.LinearField(g=0.2, axis=0), WALLS))
    field = port(jfield)
    pos, occ = torch.from_numpy(np.array(end.pos)), torch.from_numpy(
        np.array(end.occ))
    t_org = torch.from_numpy(org)
    shifted = torch.tensor([kw["box_length"] / 2, 0.0])

    def ref(pos, occ, org, shifted):
        return (jext.physical_positions(jcfg, pos, occ, org),
                jext.total_field_energy_cells(jcfg, jfield, pos, occ, org),
                jext.field_violations(jcfg, jfield, pos, occ, shifted))

    want, e_want, bad_want = jax.jit(ref)(end.pos, end.occ, org,
                                          shifted.numpy())
    got = extfield.physical_positions(cfg, pos, occ, t_org)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    e_want = float(e_want)
    for dtype in (torch.float32, torch.float64):
        e = float(extfield.total_field_energy_cells(cfg, field, pos, occ,
                                                    t_org, dtype))
        assert abs(e - e_want) <= TOTAL_REL * abs(e_want), (dtype, e, e_want)
    # a frame half a box off puts particles into the walls
    assert int(extfield.field_violations(cfg, field, pos, occ, shifted)) == \
        int(bad_want) > 0


# ---- a species-resolved field over a 2D LJ mixture ----------------------

def _mix_lj():
    """tests/test_extfield.py::_mix_lj."""
    return JaxLJMixture(epsilon=((0.3, 0.2), (0.2, 0.25)),
                        sigma=((1.0, 0.9), (0.9, 0.8)),
                        r_cut_table=((2.5, 2.25), (2.25, 2.0)))


# One configuration, pair potential and field for both cases, so that
# mcjax compiles the sub-steps once: :151's LJ mixture, step and beta, and
# its trap composed with :220's per-species wall margins (a species-1
# center keeps 1.0 off each wall, a species-0 one none).
MIX_KW = dict(dim=2, n_atoms=64, box_length=12.0, cells_per_side=4, nmax=16,
              n_moves=4, proposal="uniform", step_size=0.4, beta=1.5)
MIX_FIELD = jf.CompositeField((
    jf.HarmonicTrap(stiffness=0.4, dim=2),
    jf.SlitWalls(lo=-4.0, hi=4.0, axis=0, diameters=(0.0, 2.0))))


def _mixture_cases():
    """The starts of tests/test_extfield.py:151 (random over the box, 40 %
    species 1) and :220 (alternating species, each center within its
    margins), each with its frame origin and key."""
    rng = np.random.default_rng(3)
    r151 = rng.uniform(-6, 6, (64, 2)).astype(np.float32)
    s151 = (rng.random(64) < 0.4).astype(np.int32)
    rng = np.random.default_rng(7)
    s220 = (np.arange(64) % 2).astype(np.int32)
    margin = np.where(s220 == 1, 1.0, 0.0)
    x = rng.uniform(-4.0 + margin + 1e-3, 4.0 - margin - 1e-3)
    r220 = np.stack([x, rng.uniform(-6, 6, 64)], 1).astype(np.float32)
    return {"trap": (r151, s151, (0.4, -0.7), 21),
            "walls_species": (r220, s220, (0.0, 0.8), 22)}


@functools.lru_cache(maxsize=None)
def _mixture_run():
    """mcjax's mixture sub-step of each color under MIX_FIELD, jitted once
    with the start, the frame origin and the key as arguments."""
    cfg, pot = JaxConfig(**MIX_KW), _mix_lj()

    def run(pos, occ, org, k):
        return (jsweep.substep_randoms(cfg, k, cfg.block_shape,
                                       need_acc=True),
                [jmix.color_substep_mixture(cfg, pot, c, pos, occ, k,
                                            field=MIX_FIELD, origin=org)
                 for c in range(cfg.n_colors)])
    return jax.jit(run)


def mixture_substeps(name):
    """Case ``name``'s start (binned by the port's ``init_mixture_state``),
    origin, and mcjax's sub-step of each color from it with the draws (one
    key for all colors)."""
    r, s, org, key = _mixture_cases()[name]
    org = np.float32(org)
    st = mixture.init_mixture_state(mt.SimConfig(**MIX_KW),
                                    torch.from_numpy(r), torch.from_numpy(s),
                                    "cpu")
    jst = _jax_state(MIX_KW, st)
    return st, org, jax.tree_util.tree_map(np.array, _mixture_run()(
        jst.pos, jst.occ, jnp.asarray(org), jax.random.key(key)))


@pytest.mark.parametrize("name", ["trap", "walls_species"])
def test_mixture_field_substeps_match_mcjax(name):
    tst, org, (draws, subs) = mixture_substeps(name)
    cfg, field = mt.SimConfig(**MIX_KW), port(MIX_FIELD)
    jpot = _mix_lj()
    pot = mt.LJMixture(jpot.epsilon, jpot.sigma, jpot.r_cut_table)
    draws = [torch.from_numpy(a) for a in draws]
    ties = 0
    for color, (own, de, acc, prop) in enumerate(subs):
        rec = {}
        got, t_de, t_acc, t_prop = mixture.color_substep_mixture(
            cfg, pot, color, tst.pos, tst.occ, *draws, rec, field=field,
            origin=torch.from_numpy(org))
        n = _check_cells(got, own, rec["margin"])
        ties += n
        np.testing.assert_array_equal(_bits(got[2].numpy()), _bits(own[2]))
        if not n:
            np.testing.assert_allclose(float(t_de), float(de), rtol=DE_REL,
                                       atol=DE_ABS)
            assert int(t_acc) == int(acc) and int(t_prop) == int(prop)
    print(f"{name}: {ties} cells decided within {NEAR_TIE} of a tie")


# ---- energy anchor -------------------------------------------------------

# Few sweeps, yet enough that dropping the field's dE from the sub-step, or
# freezing the origin, fails the gate (each does, from 2 sweeps on); the
# second sweep is the first to run at a nonzero origin.
ANCHOR_SWEEPS = 2


def test_energy_anchor_trapped_lj():
    """tests/test_extfield_pallas.py:145 through the port (its own random
    numbers): the summed dE equals the change of pair + field totals,
    across grid shifts that move the frame origin every sweep."""
    cfg = mt.SimConfig(dim=2, n_atoms=64, box_length=12.0, cells_per_side=4,
                       nmax=10, n_moves=4, proposal="uniform",
                       step_size=0.4, beta=1.5)
    pot = mt.LennardJones(epsilon=0.3, sigma=1.0, r_cut=2.5)
    field = tf.HarmonicTrap(stiffness=0.4, dim=2)
    st = mt.init_state(cfg, "cpu")
    org = torch.zeros(2)

    def total(st, org):
        return (float(mt.total_energy_cells(cfg, pot, st.pos, st.occ,
                                            torch.float64))
                + float(extfield.total_field_energy_cells(
                    cfg, field, st.pos, st.occ, org, torch.float64)))

    e0 = total(st, org)
    randoms = mt.TorchRandoms(torch.Generator().manual_seed(4))
    st, org, m = extfield.run_field_sweeps(cfg, pot, field, st, org,
                                           ANCHOR_SWEEPS, randoms)
    assert not bool(st.overflow)
    e1 = total(st, org)
    traced = float(m.delta_e.double().sum())
    assert abs((e1 - e0) - traced) < ANCHOR_REL * max(abs(e1 - e0), 1.0), \
        (e0, e1, traced)
    assert int(m.accepted.sum()) > 0 and float(org.abs().sum()) > 0


# ---- the kernels' field parameters and coverage (host side) --------------

def test_field_params_round_as_the_plain_version():
    """The field form's constants: wall bounds as ``SlitWalls.bounds``
    rounds them (one pair, or one a species), f32 couplings and trap
    constants; a field no kernel covers raises naming it."""
    f = port(FIELDS["species_trap_gravity"][1])
    fp = cuda_substep.field_params(f, 3, resolved=True)
    assert (fp.n, fp.energetic) == (3, 1)
    trap, lin, walls = fp.t[0], fp.t[1], fp.t[2]
    assert (trap.kind, trap.species, list(trap.coupling)) == \
        (0, 1, [np.float32(0.7), np.float32(1.9)])
    assert list(trap.k) == [np.float32(0.2)] * 3
    assert (lin.kind, lin.axis, lin.g, lin.unit) == (1, 0, np.float32(0.3), 0)
    lo, hi = f.fields[2].bounds(torch.zeros(3, 2), torch.tensor([0.0, 1.0]))
    assert list(walls.lo) == lo.tolist() and list(walls.hi) == hi.tolist()
    single = cuda_substep.field_params(port(FIELDS["walls"][1]), 3, False)
    assert single.t[0].lo[0] == np.float32(-4.15 + 0.55)
    assert single.t[0].hi[1] == np.float32(3.85 - 0.55)
    nested = tf.CompositeField((tf.CompositeField((tf.LinearField(),)),))
    with pytest.raises(NotImplementedError, match="CompositeField"):
        cuda_substep.field_params(nested, 3, False)
    with pytest.raises(NotImplementedError, match="at most"):
        cuda_substep.field_params(tf.CompositeField((tf.LinearField(),) * 5),
                                  3, False)


def test_record_frames_are_physical_positions():
    """``run_field_sweeps_record``: each frame is the physical unbinning
    after its sweeps, and its metrics the sums of a plain run's with the
    same random numbers (bit for bit: the same sweeps in the same
    order)."""
    kw, st = _slit_setup(seed=2)
    cfg, field = mt.SimConfig(**kw), port(WALLS)
    pot = mt.HardSphere(1.0)

    def run(record):
        randoms = mt.TorchRandoms(torch.Generator().manual_seed(6))
        state = to_torch(st)
        origin = torch.zeros(2)
        if record:
            return extfield.run_field_sweeps_record(cfg, pot, field, state,
                                                    origin, 3, 2, randoms)
        return extfield.run_field_sweeps(cfg, pot, field, state, origin, 6,
                                         randoms)

    end, org, frames, agg = run(True)
    end2, org2, m = run(False)
    assert frames.shape == (3, cfg.n_atoms, 2)
    np.testing.assert_array_equal(
        _bits(frames[-1].numpy()),
        _bits(extfield.physical_positions(cfg, end.pos, end.occ, org).numpy()))
    np.testing.assert_array_equal(_bits(end.pos.numpy()),
                                  _bits(end2.pos.numpy()))
    assert torch.equal(org, org2)
    assert agg.accepted.tolist() == m.accepted.reshape(3, 2).sum(1).tolist()
    assert agg.proposed.tolist() == m.proposed.reshape(3, 2).sum(1).tolist()
