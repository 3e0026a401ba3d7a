"""The port's NPT ensemble (``mcjax_torch.ops.npt``) against mcjax.ops.npt.

Small configurations, on the CPU, through the plain path (the wrappers of
the NPT kernel forms run their plain versions on CPU tensors). Gates, with
their tolerances:

* scale 1 through the sub-step equals the NVT sub-step bit for bit (the
  twin of tests/test_npt.py::test_scale_one_is_bitwise_nvt), for hard
  disks, LJ and the Kob-Andersen mixture;
* the hard-disk NPT chain of tests/test_npt.py::
  test_npt_pallas_substep_bitwise_matches_xla (48 disks, 12 sweeps, the
  run mcjax locks its Pallas K4 to) equals mcjax's ``run_npt`` bit for bit
  when the port is fed mcjax's draws, volume moves included: positions,
  occupancies, ``log_scale``, volumes, volume accepts and particle counts;
* torch's float32 ``exp`` and ``log`` on the CPU are within one ulp of
  XLA's, on the values that chain meets and on 2^16 arguments of each
  range NPT meets (they do differ by that ulp on some; a decision flips
  only if it falls in that ulp, and none of the chain's does);
* particles, cells and the one-ring contract hold under volume moves, and
  ``volume_every`` schedules them (tests/test_npt.py:68, :108);
* the carried energy of a 2D shifted-LJ run and of a Kob-Andersen run
  meets the float32 cell total at the final scale within mcjax's own
  bounds (1e-3 and 2e-3 relative; tests/test_npt.py:83, :248);
* the scaled cell totals equal mcjax's ``total_interaction_cells(scale=)``
  and ``total_interaction_cells_mixture(scale=)`` within F32_TOTAL_REL
  (the float32 sums run in another order, ROADMAP C7), overlaps exactly;
* the NPT kernels' culling (``keep_frozen`` under scale) keeps every slot
  mcjax's scaled pair term or overlap counts at s = 0.97 and 1.03;
* an NPT run's particle draws are the NVT run's from the same seed: the
  volume moves draw from a generator of their own.
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
from mcjax.models.mixtures import kob_andersen as jax_kob_andersen
from mcjax.models.potentials import HardSphere as JaxHardSphere
from mcjax.models.potentials import LennardJones as JaxLennardJones
from mcjax.ops import mixture as jmix
from mcjax.ops import npt as jnpt
from mcjax.ops import sweep as jsweep

import mcjax_torch as mt
from mcjax_torch import bench
from mcjax_torch.ops import cells, cuda_substep, mixture
from mcjax_torch.ops import sweep as tsweep
from mcjax_torch.ops.random import TorchRandoms
from shared_reference import shared

from test_torch_culling import _cfg as _cull_cfg
from test_torch_culling import _placements, _r2

# tests/test_npt.py:124's chain
CHAIN_KW = dict(dim=2, n_atoms=48, box_length=12.0, cells_per_side=6, nmax=6,
                n_moves=3, proposal="uniform", step_size=0.1, beta=1.0)
CHAIN_P, CHAIN_DLNV, CHAIN_SWEEPS = 0.6, 0.05, 12
# tests/test_npt.py:68 and :108
DISK_KW = dict(dim=2, n_atoms=64, box_length=16.0, cells_per_side=8, nmax=6,
               n_moves=2, proposal="uniform", step_size=0.1, beta=1.0)
# tests/test_npt.py:83
LJ2D_KW = dict(dim=2, n_atoms=48, box_length=12.0, cells_per_side=4, nmax=10,
               n_moves=3, proposal="gaussian", step_size=0.15, beta=0.8)
F32_TOTAL_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npt_draws(cfg: JaxConfig, dlnv_max: float):
    """mcjax's key tree for one NPT sweep from key and sweep (the count
    before it): the schedule and sub-step draws of ``mc_sweep`` and the
    volume move's (dlnv, u) of ``npt_sweep``. Not jitted: the chain traces
    it with mcjax's ``run_npt``, for one compile."""
    def draws(key, sweep):
        k_perm, k_axis, k_dist, k_sub = jax.random.split(
            jax.random.fold_in(key, sweep), 4)
        perm = jax.random.permutation(k_perm, cfg.n_colors)
        axis = jax.random.randint(k_axis, (), 0, cfg.dim)
        half_w = cfg.cell_width / 2.0
        d = jax.random.uniform(k_dist, (), minval=-half_w, maxval=half_w)
        subs = [jsweep.substep_randoms(cfg, jax.random.fold_in(k_sub, i),
                                       cfg.block_shape, need_acc=False)
                for i in range(cfg.n_colors)]
        k_prop, k_acc = jax.random.split(
            jax.random.fold_in(key, -(sweep + 2)))
        dlnv = jax.random.uniform(k_prop, (), minval=-dlnv_max,
                                  maxval=dlnv_max)
        u = jax.random.uniform(k_acc, (), minval=1e-38, maxval=1.0)
        return (perm, axis, d, jnp.stack([s[0] for s in subs]),
                jnp.stack([s[1] for s in subs]), dlnv, u)
    return draws


class MCJaxNPTRandoms:
    """Provider that hands the port mcjax's own random numbers for a
    hard-core NPT run: ``tree``, the draws of ``_npt_draws`` stacked over
    the sweep counts."""

    def __init__(self, tree):
        self.tree = [torch.from_numpy(np.array(a)) for a in tree]

    def _draw(self, sweep):
        return [a[sweep] for a in self.tree]

    def schedule(self, cfg, sweep):
        perm, axis, d = self._draw(sweep)[:3]
        return perm.to(torch.int32), axis.to(torch.int32), d

    def substep(self, cfg, sweep, i, need_acc):
        assert not need_acc
        pick_u, disp = self._draw(sweep)[3:5]
        return pick_u[i].contiguous(), disp[i].contiguous(), None

    def volume(self, cfg, sweep, dlnv_max):
        # the port asks after the sweep (sweep counts it); mcjax keys the
        # move by the count before it
        return tuple(self._draw(sweep - 1)[5:])


def _bits(t):
    a = np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _mcjax_chain():
    """mcjax's hard-disk NPT chain from the lattice start of mcjax's
    ``init_state(cfg, seed=4)`` (the port bins it bit for bit,
    tests/test_torch_cells.py; built here from the port's state, which
    spares a compile), and its draws: (final positions, occupancies and
    log scale, metrics, draw tree), numpy only."""
    jcfg, cfg = JaxConfig(**CHAIN_KW), mt.SimConfig(**CHAIN_KW)
    tst = mt.init_state(cfg, "cpu")
    st0 = JaxState(pos=jnp.asarray(tst.pos.numpy()),
                   occ=jnp.asarray(tst.occ.numpy()), key=jax.random.key(4),
                   sweep=jnp.zeros((), jnp.int32), overflow=jnp.asarray(False))
    draws = _npt_draws(jcfg, CHAIN_DLNV)

    def reference(st):
        run = jnpt.run_npt(jcfg, JaxHardSphere(1.0), jnpt.init_npt(st),
                           CHAIN_P, CHAIN_SWEEPS, CHAIN_DLNV)
        return run, jax.vmap(draws, (None, 0))(st.key,
                                                jnp.arange(CHAIN_SWEEPS))

    (jst, jm), tree = jax.jit(reference)(st0)
    end = SimpleNamespace(sim=SimpleNamespace(pos=np.array(jst.sim.pos),
                                              occ=np.array(jst.sim.occ)),
                          log_scale=np.array(jst.log_scale))
    return (end, jax.tree_util.tree_map(np.asarray, jm),
            jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """mcjax's hard-disk NPT chain (``_mcjax_chain``, built once per run
    and shared by the workers) and the port's, fed the same draws."""
    jst, jm, tree = shared(tmp_path_factory, "torch_npt_chain",
                           _mcjax_chain)
    cfg = mt.SimConfig(**CHAIN_KW)
    rnd = MCJaxNPTRandoms(tree)
    got, gm = mt.run_npt(cfg, mt.HardSphere(1.0),
                         mt.init_npt(mt.init_state(cfg, "cpu")), CHAIN_P,
                         CHAIN_SWEEPS, rnd, CHAIN_DLNV)
    return (jst, jm, got, gm, rnd)


def test_hard_disk_npt_chain_bitwise(chain):
    """Bit for bit but the volumes, which are exp(log_scale) raised to dim
    and carry the one-ulp difference of torch's exp from XLA's (within
    4 float32 ulps, relative 5e-7)."""
    jst, jm, got, gm, _ = chain
    for a, b in ((got.sim.pos, jst.sim.pos), (got.sim.occ, jst.sim.occ),
                 (got.log_scale, jst.log_scale),
                 (gm.vol_accepted, jm.vol_accepted),
                 (gm.sweep.accepted, jm.sweep.accepted),
                 (gm.sweep.proposed, jm.sweep.proposed),
                 (gm.sweep.overflow, jm.sweep.overflow)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    np.testing.assert_allclose(gm.volume.numpy(), jm.volume, rtol=5e-7)
    assert got.sim.sweep == CHAIN_SWEEPS
    assert 0 < int(gm.vol_accepted.sum()) < CHAIN_SWEEPS
    assert float(got.log_scale) != 0.0


def test_exp_log_within_one_ulp_of_xla(chain):
    """exp of every log_scale and dlnv / dim and log of every acceptance
    uniform of the chain, torch on the CPU (0-d tensors, as the port
    computes them) against XLA (0-d, jitted), and of 2^16 arguments in
    [-0.3, 0.3) and (0, 1) (vectors): at most one ulp apart."""
    _, _, _, gm, rnd = chain
    dim = CHAIN_KW["dim"]
    step = [rnd._draw(s)[5] / dim for s in range(CHAIN_SWEEPS)]
    u = [rnd._draw(s)[6] for s in range(CHAIN_SWEEPS)]
    log_s, logs = torch.zeros(()), [torch.zeros(())]
    for d, acc in zip(step, gm.vol_accepted):
        log_s = torch.where(acc, log_s + d, log_s)
        logs.append(log_s)
    j_exp, j_log = jax.jit(jnp.exp), jax.jit(jnp.log)
    for x, t_fn, j_fn in ((step + logs, torch.exp, j_exp),
                          (u, torch.log, j_log)):
        got = np.array([t_fn(v).numpy() for v in x]).view(np.int32)
        want = np.array([np.asarray(j_fn(v.numpy())) for v in x]).view(
            np.int32)
        assert np.abs(got.astype(np.int64) - want).max() <= 1
    rng = np.random.default_rng(8)
    for x, t_fn, j_fn in (
            (rng.uniform(-0.3, 0.3, 1 << 16), torch.exp, j_exp),
            (rng.uniform(1e-38, 1.0, 1 << 16), torch.log, j_log)):
        x = x.astype(np.float32)
        got = t_fn(torch.from_numpy(x)).numpy().view(np.int32)
        want = np.asarray(j_fn(x)).view(np.int32)
        assert np.abs(got.astype(np.int64) - want).max() <= 1


@pytest.mark.parametrize("model", ["disks", "lj3d", "ka3d"])
def test_scale_one_is_bitwise_nvt(model):
    """A sub-step at scale 1 (s^2 = 1 exactly) equals the NVT sub-step bit
    for bit, dE and counts included."""
    if model == "disks":
        cfg, pot = mt.SimConfig(**CHAIN_KW), mt.HardSphere(1.0)
        st = mt.init_state(cfg, "cpu")
    elif model == "lj3d":
        cfg, pot, st = bench.build_lj3d(1000, 24, 6, device="cpu")
    else:
        cfg, pot, st = bench.build_ka3d(1300, 34, 4, device="cpu")
    g = torch.Generator().manual_seed(3)
    bs = cfg.block_shape
    pick_u = torch.rand((cfg.n_moves, *bs), generator=g)
    disp = 0.1 * torch.randn((cfg.n_moves, cfg.dim, *bs), generator=g)
    acc_u = torch.rand((cfg.n_moves, *bs), generator=g)
    plain = (mixture.color_substep_mixture if model == "ka3d"
             else cuda_substep.color_substep)
    nvt = plain(cfg, pot, 1, st.pos, st.occ, pick_u, disp, acc_u)
    one = plain(cfg, pot, 1, st.pos, st.occ, pick_u, disp, acc_u,
                scale=torch.tensor(1.0))
    for a, b in zip(nvt, one):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    assert int(nvt[2]) > 0


def _disk_npt(sweeps, pressure, dlnv_max, volume_every=1, seed=0):
    cfg, pot = mt.SimConfig(**DISK_KW), mt.HardSphere(1.0)
    nst = mt.init_npt(mt.init_state(cfg, "cpu"))
    rnd = TorchRandoms(torch.Generator().manual_seed(seed))
    return cfg, pot, *mt.run_npt(cfg, pot, nst, pressure, sweeps, rnd,
                                 dlnv_max, volume_every)


def test_volume_moves_conserve_particles_and_cells():
    cfg, pot, nst, m = _disk_npt(50, 0.5, 0.05)
    assert int(nst.sim.occ.sum()) == cfg.n_atoms
    assert not bool(nst.sim.overflow) and not bool(m.sweep.overflow.any())
    assert float(nst.log_scale) != 0.0
    assert 0 < int(m.vol_accepted.sum()) < 50
    side = torch.sqrt(m.volume.double()) / cfg.box_length
    assert float(side.min()) * cfg.cell_width >= 1.0
    mt.validate_state(cfg, nst.sim, pot, scale=float(nst.scale))


def test_volume_every_schedule():
    cfg, _, nst, m = _disk_npt(40, 0.5, 0.05, volume_every=4)
    acc = m.vol_accepted.numpy()
    on = np.array([(i + 1) % 4 == 0 for i in range(40)])
    assert not acc[~on].any() and acc[on].any()
    assert int(nst.sim.occ.sum()) == cfg.n_atoms


def test_fixed_scale_sweeps_are_npt_sweeps_without_volume_moves():
    """``run_sweeps`` at a fixed scale s equals ``run_npt`` from log s over
    sweeps that hold no volume move (``volume_every`` beyond the run), bit
    for bit: states and metrics."""
    cfg, pot = mt.SimConfig(**DISK_KW), mt.HardSphere(1.0)
    log_s = torch.tensor(math.log(0.98), dtype=torch.float32)
    nst, m = mt.run_npt(cfg, pot, mt.NPTState(mt.init_state(cfg, "cpu"),
                                              log_s),
                        0.5, 4, TorchRandoms(torch.Generator().manual_seed(6)),
                        0.05, volume_every=5)
    st, ms = mt.run_sweeps(cfg, pot, mt.init_state(cfg, "cpu"), 4,
                           TorchRandoms(torch.Generator().manual_seed(6)),
                           scale=torch.exp(log_s))
    assert not bool(m.vol_accepted.any()) and nst.log_scale == log_s
    for a, b in ((nst.sim.pos, st.pos), (nst.sim.occ, st.occ),
                 *zip(m.sweep, ms)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))
    assert int(ms.accepted.sum()) > 0


def test_npt_particle_draws_equal_nvt():
    """From one seed, an NPT run and an NVT run draw the same schedule and
    sub-step tensors, in the same order, on the CPU and with the volume
    move after every sweep."""
    cfg, pot = mt.SimConfig(**DISK_KW), mt.HardSphere(1.0)

    class Recorder(TorchRandoms):
        def __init__(self, g):
            super().__init__(g)
            self.log = []

        def schedule(self, cfg, sweep):
            out = super().schedule(cfg, sweep)
            self.log += out
            return out

        def substep(self, cfg, sweep, i, need_acc):
            out = super().substep(cfg, sweep, i, need_acc)
            self.log += [t for t in out if t is not None]
            return out

    a, b = Recorder(torch.Generator().manual_seed(5)), \
        Recorder(torch.Generator().manual_seed(5))
    mt.run_npt(cfg, pot, mt.init_npt(mt.init_state(cfg, "cpu")), 0.5, 4, a,
               0.05)
    mt.run_sweeps(cfg, pot, mt.init_state(cfg, "cpu"), 4, b)
    assert len(a.log) == len(b.log) == 4 * (3 + 2 * cfg.n_colors)
    for x, y in zip(a.log, b.log):
        assert torch.equal(x, y)
    assert a.volume_generator is not None and b.volume_generator is None


def test_carried_energy_2d_shifted_lj():
    """tests/test_npt.py:83 on the port's plain path (there 120 sweeps, and
    120 re-anchored every 16; here 10 and 10 more, re-anchored at sweep 16,
    for the CPU tests' time budget): the carried energy meets the cell
    total at the final scale within mcjax's 1e-3. (At 10 sweeps a chain
    that drops the accepted volume moves' dU, or the sweeps' dE, misses
    the bound by 20-60x.)"""
    cfg = mt.SimConfig(**LJ2D_KW)
    pot = mt.LennardJones(r_cut=2.5, shift=True)
    rnd = TorchRandoms(torch.Generator().manual_seed(2))
    nst = mt.init_npt(mt.init_state(cfg, "cpu"))
    taken = 0
    for anchor_every in (0, 16):
        nst, m = mt.run_npt(cfg, pot, nst, 0.5, 10, rnd, 0.03, 1,
                            anchor_every)
        u = float(mt.total_energy_cells(cfg, pot, nst.sim.pos, nst.sim.occ,
                                        scale=nst.scale))
        assert abs(float(m.energy[-1]) - u) <= 1e-3 * max(1.0, abs(u))
        taken += int(m.vol_accepted.sum())
    assert 0 < taken < 20
    assert int(nst.sim.occ.sum()) == cfg.n_atoms


def _ka_small():
    """tests/test_npt.py:248's Kob-Andersen system (320 atoms at rho 1.2,
    tables scaled by 0.6 so the largest cutoff fits a cell)."""
    n, cps = 320, 4
    cfg = mt.SimConfig(dim=3, n_atoms=n, box_length=(n / 1.2) ** (1 / 3),
                       cells_per_side=cps, nmax=3 * (n // cps ** 3) + 10,
                       n_moves=2, proposal="gaussian", step_size=0.09,
                       beta=1.0 / 0.8, seed=2)
    sig = tuple(tuple(0.6 * x for x in row)
                for row in ((1.0, 0.8), (0.8, 0.88)))
    kw = dict(epsilon=((1.0, 1.5), (1.5, 0.5)), sigma=sig,
              r_cut_table=tuple(tuple(2.5 * x for x in row) for row in sig))
    cfg.validate_against(max(max(r) for r in kw["r_cut_table"]))
    return cfg, kw


def test_carried_energy_kob_andersen():
    """tests/test_npt.py:248 on the port's plain path (there 25 sweeps with
    a volume move after each, here 5 with one after every second, so the
    last sweep's dE follows the last volume move): the carried energy
    meets the species-resolved cell total at the final scale within
    mcjax's 2e-3, with A and B conserved. (A chain that drops the accepted
    volume move's dU, or the sweeps' dE, misses the bound by 3x or 18x.)"""
    cfg, kw = _ka_small()
    ka = mt.LJMixture(**kw)
    spec = (torch.arange(cfg.n_atoms) % 5 == 0).to(torch.int32)
    st = mt.init_mixture_state(cfg, cells.lattice_positions(cfg),
                               spec, "cpu")
    rnd = TorchRandoms(torch.Generator().manual_seed(2))
    nst, m = mt.run_npt(cfg, ka, mt.init_npt(st), 5.0, 5, rnd, 0.02, 2)
    e, ov = mixture.total_interaction_cells_mixture(
        cfg, ka, nst.sim.pos, nst.sim.occ, scale=nst.scale)
    assert not bool(ov) and not bool(nst.sim.overflow)
    assert int(m.sweep.accepted.sum()) > 0
    assert int(m.vol_accepted.sum()) > 0
    assert abs(float(m.energy[-1]) - float(e)) < 2e-3 * max(1.0, abs(float(e)))
    assert mixture.species_counts(cfg, nst.sim.pos, nst.sim.occ,
                                  2).tolist() == [256, 64]


def _jittered_state(kw, seed, species=False):
    """The lattice start of ``kw`` with every atom moved by up to 0.1 on
    each axis (numpy, seeded)."""
    cfg = mt.SimConfig(**kw)
    rng = np.random.default_rng(seed)
    x = cells.lattice_positions(cfg) + torch.from_numpy(
        rng.uniform(-0.1, 0.1, (cfg.n_atoms, cfg.dim)).astype(np.float32))
    if species:
        spec = torch.from_numpy((np.arange(cfg.n_atoms) % 5 == 4).astype(
            np.int32))
        return cfg, mt.init_mixture_state(cfg, x, spec, "cpu")
    return cfg, mt.init_state(cfg, "cpu", x)


@pytest.mark.parametrize("model", ["lj2d", "ka3d"])
def test_scaled_totals_match_mcjax(model):
    """The cell totals at s = 0.97 and 1.03 against mcjax's, on a jittered
    lattice: the energy within F32_TOTAL_REL. (The hard-disk totals' overlap
    flags decide the volume moves of the bitwise chain above.)"""
    if model == "lj2d":
        kw = LJ2D_KW
        pot = mt.LennardJones(r_cut=2.5, shift=True)
        jpot = JaxLennardJones(r_cut=2.5, shift=True)
        fn = jsweep.total_interaction_cells
    else:
        kw = dict(dim=3, n_atoms=100, box_length=10.0, cells_per_side=4,
                  nmax=12, n_moves=1, proposal="gaussian", step_size=0.1,
                  beta=1.0)
        pot, jpot = mt.kob_andersen(), jax_kob_andersen()
        fn = jmix.total_interaction_cells_mixture
    cfg, st = _jittered_state(kw, 7, model == "ka3d")
    jcfg = JaxConfig(**kw)
    total = jax.jit(lambda p, o, s: fn(jcfg, jpot, p, o, scale=s))
    for s in (0.97, 1.03):
        want_e, want_ov = total(st.pos.numpy(), st.occ.numpy(),
                                jnp.float32(s))
        e, ov = tsweep.total_interaction(cfg, pot, st.pos, st.occ,
                                         scale=torch.tensor(s))
        assert bool(ov) == bool(want_ov)
        assert abs(float(e) - float(want_e)) <= F32_TOTAL_REL * max(
            1.0, abs(float(want_e)))


@pytest.mark.parametrize("workload", ["lj3d", "ka3d", "disks"])
@pytest.mark.parametrize("scale", [0.97, 1.03])
def test_culling_under_scale_keeps_every_slot_mcjax_counts(workload, scale):
    """``keep_frozen`` with the reach divided by s^2: slots 1-4 float32
    ulps in and out of r_cut / s from the cell's nearest points are kept
    wherever mcjax's pair term at s^2 r2 is non-zero (or, for hard disks,
    its overlap counts), and slots 1e-3 beyond r_cut / s are dropped."""
    s2 = np.float32(np.float32(scale) * np.float32(scale))
    if workload == "disks":
        box, cps = math.sqrt((1 << 20) * math.pi / 4 / 0.5), 640
        cfg = mt.SimConfig(dim=2, n_atoms=1, box_length=box,
                           cells_per_side=cps, nmax=7, n_moves=1)
        r_cut = 1.0
        jpot = JaxHardSphere(r_cut)

        def counts(r2):
            return np.asarray(jpot.overlap(s2 * r2))
    else:
        cfg = _cull_cfg(workload)
        if workload == "lj3d":
            jpot = JaxLennardJones(r_cut=2.5)
            r_cut = jpot.r_cut

            def counts(r2):
                return np.asarray(jpot.pair_energy(s2 * r2)) != 0
        else:
            jpot = jax_kob_andersen(shift=False)
            r_cut = max(max(row) for row in jpot.r_cut_table)

            def counts(r2):
                return np.any([np.asarray(jpot.pair_energy_s(
                    s2 * r2, jnp.full(r2.shape, si),
                    jnp.full(r2.shape, sj))) != 0
                    for si in (0, 1) for sj in (0, 1)], axis=0)
    pad, _ = cuda_substep.cull_constants(cfg, r_cut)
    reach = r_cut / scale
    top = cfg.half_cps - 1
    counted = 0
    for color, block in ((0, (3,) * cfg.dim), (cfg.n_colors - 1,
                                               (top,) * cfg.dim)):
        x, y, lower = _placements(cfg, color, block, reach)
        if workload == "disks":
            r2 = cuda_substep.squared_norm(torch.from_numpy(x - y),
                                           -1).numpy()
        else:
            r2 = np.asarray(_r2(jnp.asarray(x), jnp.asarray(y)))
        hit = counts(r2)
        keep = cuda_substep.keep_frozen(cfg, r_cut, lower,
                                        torch.from_numpy(y), scale).numpy()
        assert not np.any(hit & ~keep)
        counted += int(hit.sum())
        unit = (y - x) / np.linalg.norm(y - x, axis=-1, keepdims=True)
        far = (x + unit * np.float32(reach + 1e-3 + 2 * pad)).astype(
            np.float32)
        inside = np.all((x >= lower.numpy())
                        & (x < lower.numpy() + cfg.cell_width), axis=-1)
        assert not cuda_substep.keep_frozen(
            cfg, r_cut, lower, torch.from_numpy(far[inside]), scale).any()
    assert counted > 0
