"""The statistical RNG gate and the keyed frame replay, on the CPU.

``mcjax_torch.utils.rng_gate.run_gate`` end to end at a tiny size (the
plain path materializes the Philox draws), and against a provider whose
acceptance uniforms are skewed (u -> u^2), which it must fail: the gate
has teeth. ``mcjax_torch.ops.extfield.replay_origin`` fed mcjax's key tree
(the schedule provider of ``tests/test_torch_field.py``) against mcjax's
``replay_origin``, and under ``PhiloxRandoms`` against the origin that
``field_sweep`` carried, all bit for bit.

At the tiny size the statistical checks have little power, so the honest
run is held to its exact checks (capacity, the dE anchor: the energy
identity holds whatever the draws) and to its check list; the skewed
provider's acceptance gap must be far outside the 0.01 threshold.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.ops import extfield as jext

import mcjax_torch as mt
from mcjax_torch import bench
from mcjax_torch.models import fields
from mcjax_torch.ops import extfield
from mcjax_torch.ops.random import PhiloxRandoms
from mcjax_torch.utils import rng_gate
from test_torch_field import Replay

TINY = dict(disks=1024, disk_sweeps=2, disk_moves=16, lj=1000, lj_sweeps=2,
            lj_moves=6, ka=1300, ka_sweeps=1, ka_moves=4, ka_nmax=34)
CHECKS = ["hard-disk acceptance parity", "hard-disk contact EOS parity",
          "3D LJ capacity (host RNG)", "3D LJ capacity (in-kernel RNG)",
          "3D LJ acceptance parity", "3D LJ dE-anchor (host RNG)",
          "3D LJ dE-anchor (in-kernel RNG)", "3D LJ energy/atom parity",
          "ka3d capacity (host RNG)", "ka3d capacity (in-kernel RNG)",
          "ka3d acceptance parity", "ka3d dE-anchor (host RNG)",
          "ka3d dE-anchor (in-kernel RNG)"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_gate():
    return rng_gate.run_gate(8, "cpu", TINY, quiet=True)


def _checks(res):
    return {c["name"]: c for c in res["checks"]}


def test_gate_runs_end_to_end(tiny_gate):
    checks = _checks(tiny_gate)
    assert list(checks) == CHECKS
    for name, c in checks.items():
        if "capacity" in name or "anchor" in name:
            assert c["ok"], c
    assert tiny_gate["ok"] == (not tiny_gate["failures"])
    assert tiny_gate["device"] == "cpu" and tiny_gate["ih_k"] == 8
    json.dumps(tiny_gate)


class Skewed:
    """PhiloxRandoms' draws with every acceptance uniform squared (so a
    move is taken with probability sqrt(a), not a), handed over as
    tensors."""

    def __init__(self, seed, device, ih_k):
        self.inner = PhiloxRandoms(seed, device, ih_k)
        self.device = self.inner.device

    def schedule(self, cfg, sweep):
        return self.inner.schedule(cfg, sweep)

    def substep(self, cfg, sweep, i, need_acc):
        pick_u, disp, acc_u = self.inner.substep(cfg, sweep, i, need_acc)
        return pick_u, disp, None if acc_u is None else acc_u * acc_u


def test_gate_fails_on_skewed_acceptance_uniforms(tiny_gate):
    """Squared acceptance uniforms take a move with probability sqrt(a):
    the LJ case's acceptance parity fails. The skewed run shares its
    picks and displacements with the honest one (one Philox stream) and
    the host run with it (one seed), so the difference of the two checks'
    statistics is the skew's own effect on the acceptance."""
    res = rng_gate.run_gate(8, "cpu", TINY, quiet=True, philox=Skewed,
                            cases=("lj",))
    name = "3D LJ acceptance parity"
    assert not res["ok"] and name in res["failures"]
    skewed = _checks(res)[name]["value"]
    honest = _checks(tiny_gate)[name]["value"]
    assert skewed > 0.01 and skewed - honest > 0.015
    # the energy identity holds whatever the draws
    assert _checks(res)["3D LJ dE-anchor (in-kernel RNG)"]["ok"]


def _mcjax_replay(jcfg, start, n, org0):
    """mcjax's mc_sweep schedule of sweeps 0 .. start + n - 1 from the
    config's key (as tests/test_torch_field.py's confined run draws it)
    and mcjax's replay_origin over [start, start + n), in one jit."""
    half_w = jcfg.cell_width / 2.0

    def one(key, sweep):
        k_perm, k_axis, k_dist, _ = jax.random.split(
            jax.random.fold_in(key, sweep), 4)
        return (jax.random.permutation(k_perm, jcfg.n_colors),
                jax.random.randint(k_axis, (), 0, jcfg.dim),
                jax.random.uniform(k_dist, (), minval=-half_w, maxval=half_w))

    def run(key, org):
        sched = jax.vmap(lambda s: one(key, s))(jnp.arange(start + n))
        return sched, jext.replay_origin(jcfg, key, start, n, org)

    sched, org = jax.jit(run)(jax.random.key(jcfg.seed), jnp.asarray(org0))
    return jax.tree_util.tree_map(np.array, sched), np.array(org)


def test_replay_origin_matches_mcjax():
    """Shifts every second sweep, so both branches of the step run."""
    kw = dict(dim=2, n_atoms=48, box_length=12.0, cells_per_side=4, nmax=10,
              n_moves=4, proposal="uniform", step_size=0.3, beta=1.0, seed=3,
              shift_every=2)
    jcfg, cfg = JaxConfig(**kw), mt.SimConfig(**kw)
    start, n = 3, 9
    org0 = np.float32([0.4, -5.9])
    sched, want = _mcjax_replay(jcfg, start, n, org0)
    got = extfield.replay_origin(cfg, Replay(sched, None), start, n,
                                 torch.from_numpy(org0))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert not np.array_equal(want, org0)


def test_replay_origin_equals_the_carried_origin():
    cfg, pot, st = bench.build(400, 0.5, 2.0, 7, 4, device="cpu")
    walls = fields.SlitWalls(lo=-11.0, hi=11.0, axis=0)
    st = bench.slab_start(cfg, walls, st, False)
    origin = torch.zeros(2)
    st, mid, _ = extfield.run_field_sweeps(cfg, pot, walls, st, origin, 3,
                                           PhiloxRandoms(8, "cpu"))
    st, end, _ = extfield.run_field_sweeps(cfg, pot, walls, st, mid, 3,
                                           PhiloxRandoms(8, "cpu"))
    for start, n, org, want in ((0, 6, origin, end), (3, 3, mid, end),
                                (0, 3, origin, mid)):
        got = extfield.replay_origin(cfg, PhiloxRandoms(8, "cpu"), start, n,
                                     org)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(end.abs().sum()) > 0
