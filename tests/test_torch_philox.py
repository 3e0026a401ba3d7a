"""The keyed Philox stream of the in-kernel draws, on the CPU.

``mcjax_torch.ops.random``'s ``philox4x32`` (the plain version of
``csrc/philox.cuh``) and ``PhiloxRandoms`` against Random123's
known-answer vectors, an independent integer Philox, mcjax's in-kernel
transforms (``_uniform_01`` and the Irwin-Hall sum of
``mcjax/ops/pallas_sweep.py:318-346``), and against themselves: the
words' layout, resumed runs, and the plain path under a key against the
plain path fed the same draws. Numpy and torch only, but for the two
transforms, which take mcjax's own expressions (eager JAX, no jitted
run). The kernels' Philox forms against these plain versions are in
``tests/test_torch_cuda.py``.

Tolerances: every comparison is bit for bit, but the Irwin-Hall
transform, which is within 1 float32 ulp of mcjax's expression at the
magnitude of its larger operand (mcjax, run eagerly, rounds the product
c1 S and then the difference; the port rounds once, in an fma).
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st_

from mcjax.ops.pallas_sweep import _uniform_01

import mcjax_torch as mt
from mcjax_torch import bench
from mcjax_torch.models import fields
from mcjax_torch.ops import extfield
from mcjax_torch.ops.random import (MASK32, TAG_MOVES, PhiloxRandoms,
                                    TorchRandoms, irwin_hall,
                                    irwin_hall_constants, move_layout,
                                    philox4x32, philox4x32_int, uniform_01)

KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK32,) * 4, (MASK32, MASK32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_philox(ctr, key):
    """Random123's philox4x32-10 written from its definition: full
    products of Python integers, hi = p >> 32, lo = p mod 2^32."""
    (c0, c1, c2, c3), (k0, k1) = ctr, key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) % 2**32, (k1 + 0xBB67AE85) % 2**32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 % 2**32, \
            (p0 >> 32) ^ c3 ^ k1, p0 % 2**32
    return c0, c1, c2, c3


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answer_vectors(ctr, key, want):
    t = torch.tensor(ctr, dtype=torch.int64).reshape(4, 1)
    assert tuple(philox4x32(t, key)[:, 0].tolist()) == want
    assert philox4x32_int(ctr, key) == want


@settings(max_examples=25, deadline=None)
@given(st_.lists(st_.tuples(*[st_.integers(0, MASK32)] * 4), min_size=1,
                 max_size=16),
       st_.tuples(st_.integers(0, MASK32), st_.integers(0, MASK32)))
def test_philox_equals_integer_reference(ctrs, key):
    t = torch.tensor(ctrs, dtype=torch.int64).T.contiguous()
    got = philox4x32(t, key).T.tolist()
    assert [tuple(w) for w in got] == [reference_philox(c, key)
                                       for c in ctrs]


def _words(n, seed=0):
    g = np.random.default_rng(seed)
    return g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)


def test_uniform_equals_mcjax():
    w = _words(100_000)
    w[:4] = [0, 255, 256, MASK32]
    got = uniform_01(torch.from_numpy(w)).numpy()
    want = np.asarray(_uniform_01(jnp.asarray(w.astype(np.uint32).view(
        np.int32))))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() == 0.0 and got.max() == np.float32(1 - 2**-24)


def _mcjax_irwin_hall(words, step, k):
    """mcjax/ops/pallas_sweep.py:318-346 on words [k_words, n]: the halves
    hi then lo of each word, the first k of them, a pairwise tree sum,
    scale_ih * 2^-16 * S - scale_ih * K * (0.5 - 2^-17)."""
    parts = []
    for w in words:
        u = jnp.asarray(w.astype(np.uint32))
        parts += [(u >> 16).astype(jnp.int32).astype(jnp.float32),
                  (u & 0xFFFF).astype(jnp.int32).astype(jnp.float32)]
    parts = parts[:k]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)
                 ] + (parts[-1:] if len(parts) % 2 else [])
    scale_ih = jnp.float32(step * math.sqrt(12.0 / k))
    return np.asarray(scale_ih * jnp.float32(1.0 / 65536.0) * parts[0]
                      - scale_ih * jnp.float32(k * (0.5 - 1.0 / 131072.0)))


@pytest.mark.parametrize("k", [2, 7, 8, 12, 64])
def test_irwin_hall_within_an_ulp_of_mcjax(k):
    step, n = 0.12, 20_000
    words = _words(n * ((k + 1) // 2), seed=k).reshape((k + 1) // 2, n)
    halves = np.stack([words >> 16, words & 0xFFFF], 1).reshape(-1, n)[:k]
    got = irwin_hall(torch.from_numpy(halves.sum(0)), step, k).numpy()
    want = _mcjax_irwin_hall(words, step, k)
    c1, c0 = irwin_hall_constants(step, k)
    # mcjax rounds c1 * S, then the difference: an ulp at the larger
    # operand's magnitude
    prod = np.float32(c1) * halves.sum(0).astype(np.float32)
    ulp = np.spacing(np.maximum(prod, np.float32(c0)))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)


@pytest.mark.parametrize("k", [2, 8, 12])
def test_irwin_hall_moments_and_tails(k):
    step, n = 0.12, 200_000
    words = _words(n * ((k + 1) // 2), seed=100 + k).reshape(-1, n)
    halves = np.stack([words >> 16, words & 0xFFFF], 1).reshape(-1, n)[:k]
    x = irwin_hall(torch.from_numpy(halves.sum(0)), step, k).double().numpy()
    assert abs(x.mean()) < 5 * step / math.sqrt(n)
    # var of the sample variance ~ 2 sigma^4 / n (and less: the tails are
    # lighter than a gaussian's)
    assert abs(x.var() / step**2 - 1) < 5 * math.sqrt(2 / n)
    assert np.abs(x).max() <= math.sqrt(3 * k) * step * (1 + 1e-6)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _disk_cfg(n=1024, moves=8):
    return bench.build(n, 0.5, 2.0, 7, moves, device="cpu")


def _lj_cfg(moves=2):
    return bench.build_lj3d(1000, 28, moves, device="cpu")


def test_move_words_layout():
    """A materialized draw is the word the layout names: pick is word 0,
    acc word 1, then the components (each gaussian one ceil(K/2) words,
    hi half first) of call m * calls + k at (global cell, sweep, (MOVES
    << 16) | i)."""
    cfg, _, _ = _lj_cfg(moves=6)
    k = 8
    rnd = PhiloxRandoms(0x1234_5678_9ABC, "cpu", k)
    sweep, i = 3, 5
    color = rnd.host_schedule(cfg, sweep)[0][i]
    pick, disp, acc = rnd.substep(cfg, sweep, i, True)
    per, calls = move_layout(cfg, True, k)
    assert (per, calls) == (4, 4)
    c1, c0 = irwin_hall_constants(cfg.step_size, k)
    cells = math.prod(cfg.block_shape)
    for m, cell in [(0, 0), (3, 5), (cfg.n_moves - 1, cells - 1)]:
        words = []
        for c in range(calls):
            words += philox4x32_int((m * calls + c, color * cells + cell,
                                     sweep, (TAG_MOVES << 16) | i), rnd.key)
        idx = np.unravel_index(cell, cfg.block_shape)
        assert pick[(m, *idx)] == np.float32((words[0] >> 8) * 2.0**-24)
        assert acc[(m, *idx)] == np.float32((words[1] >> 8) * 2.0**-24)
        for d in range(3):
            ws = words[2 + per * d:2 + per * (d + 1)]
            s = sum((w >> 16) + (w & 0xFFFF) for w in ws)
            assert disp[(m, d, *idx)] == np.float32(c1 * s - c0)


def test_schedule_is_keyed_and_uniform():
    cfg, _, _ = _disk_cfg()
    rnd = PhiloxRandoms(7, "cpu")
    seen = {}
    for sweep in range(2400):
        perm, axis, d = rnd.host_schedule(cfg, sweep)
        assert sorted(perm) == [0, 1, 2, 3] and axis in (0, 1)
        assert abs(float(d)) <= cfg.cell_width / 2
        seen[tuple(perm)] = seen.get(tuple(perm), 0) + 1
    assert set(seen) == set(itertools.permutations(range(4)))
    chi2 = sum((v - 100) ** 2 / 100 for v in seen.values())
    assert chi2 < 60            # 23 degrees of freedom: p ~ 4e-5
    perm, axis, d = rnd.schedule(cfg, 5)
    again = PhiloxRandoms(7, "cpu").schedule(cfg, 5)
    assert all(torch.equal(a, b) for a, b in zip((perm, axis, d), again))
    assert perm.dtype == axis.dtype == torch.int32
    assert d.dtype == torch.float32 and d.shape == ()
    dlnv, u = rnd.volume(cfg, 4, 0.02)
    assert abs(float(dlnv)) <= 0.02 and 0 < float(u) < 1


class Materialized:
    """A provider with PhiloxRandoms' draws handed over as tensors (no
    kernel key): the host-random path fed the Philox draws."""

    def __init__(self, inner):
        self.inner = inner

    def schedule(self, cfg, sweep):
        return self.inner.schedule(cfg, sweep)

    def substep(self, cfg, sweep, i, need_acc):
        return self.inner.substep(cfg, sweep, i, need_acc)


@pytest.mark.parametrize("model", ["disks", "lj"])
def test_keyed_plain_path_equals_fed_plain_path(model):
    cfg, pot, a = _disk_cfg() if model == "disks" else _lj_cfg()
    _, _, b = _disk_cfg() if model == "disks" else _lj_cfg()
    a, ma = mt.run_sweeps(cfg, pot, a, 2, PhiloxRandoms(11, "cpu", 8))
    b, mb = mt.run_sweeps(cfg, pot, b, 2,
                          Materialized(PhiloxRandoms(11, "cpu", 8)))
    assert torch.equal(a.pos.view(torch.int32), b.pos.view(torch.int32))
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)
    assert 0 < int(ma.accepted.sum()) < int(ma.proposed.sum())


@pytest.mark.parametrize("model", ["disks", "lj"])
@pytest.mark.parametrize("provider", ["philox", "torch"])
def test_resumed_run_equals_unbroken(model, provider):
    """3 + 3 sweeps, with a new provider at the break, equal 6 sweeps bit
    for bit: every draw is keyed by (seed, sweep, sub-step)."""
    def make():
        if provider == "philox":
            return PhiloxRandoms(5, "cpu", 8)
        return TorchRandoms(torch.Generator().manual_seed(5))

    build = _disk_cfg if model == "disks" else _lj_cfg
    cfg, pot, a = build()
    _, _, b = build()
    a, ma = mt.run_sweeps(cfg, pot, a, 6, make())
    b, m1 = mt.run_sweeps(cfg, pot, b, 3, make())
    b, m2 = mt.run_sweeps(cfg, pot, b, 3, make())
    assert b.sweep == 6
    assert torch.equal(a.pos.view(torch.int32), b.pos.view(torch.int32))
    assert torch.equal(a.occ, b.occ)
    for x, y, z in zip(ma, m1, m2):
        assert torch.equal(_bits(x), _bits(torch.cat([y, z])))


def test_torch_randoms_draws_do_not_depend_on_call_order():
    cfg, _, _ = _disk_cfg()
    a = TorchRandoms(torch.Generator().manual_seed(3))
    b = TorchRandoms(torch.Generator().manual_seed(3))
    x = a.substep(cfg, 4, 2, True)
    b.schedule(cfg, 9)
    b.substep(cfg, 4, 1, True)
    y = b.substep(cfg, 4, 2, True)
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert not torch.equal(x[0], a.substep(cfg, 5, 2, True)[0])


def test_field_run_under_philox_on_the_cpu():
    """A field run under PhiloxRandoms runs on the CPU (the plain path
    materializes the keyed draws), walls respected, dE of a trap summed."""
    cfg, pot, st = _disk_cfg(n=400)
    field = fields.CompositeField((
        fields.HarmonicTrap(stiffness=0.05, dim=2),
        fields.SlitWalls(lo=-11.0, hi=11.0, axis=1)))
    st = bench.slab_start(cfg, field, st, False)
    origin = torch.zeros(2)
    st, origin, m = extfield.run_field_sweeps(cfg, pot, field, st, origin, 3,
                                              PhiloxRandoms(2, "cpu"))
    assert int(extfield.field_violations(cfg, field, st.pos, st.occ,
                                         origin)) == 0
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    assert float(m.delta_e.abs().sum()) > 0
