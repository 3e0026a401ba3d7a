#!/usr/bin/env python3
"""The two slow 3D Lennard-Jones checks behind tests/test_torch_lj3d.py.

    JAX_PLATFORMS=cpu python scripts/check_torch_lj3d_reference.py

Both run on the CPU at the test's size (500 atoms, box 10, 4^3 cells,
nmax 24, n_moves 3, gaussian step 0.2, beta 0.5, stratified start) and feed
the port the JAX package's own random numbers. They take about a minute
and a half, most of it XLA compilation, which is why they are not in the
test suite:

1. ``run_sweeps``: the port's plain run of 3 sweeps equals jitted
   ``mcjax.ops.sweep.run_sweeps`` (the test holds the port against
   ``mc_sweep`` with its 3D shift run op by op).
2. K5: each of two color sub-steps of the port's plain ``color_substep``
   equals the TPU kernel ``mcjax/ops/pallas_sweep.py::_fused_core`` with
   the frozen-neighbor cache, in interpret mode (``make_fused_substep(8,
   128, interpret=True, slot_group=4, frozen_cache=True)``).

Gates are the test's: bit for bit outside cells where a decision came
within a relative 1e-5 of a tie (reported), dE within rel 1e-5 + abs 1e-4.
Check 2 allows one more kind of cell, reported apart: one whose positions
differ from the port's by at most one float32 ulp. Compiled together with
its draws, as the kernel is here, XLA on the CPU may fuse the gaussian
proposal old + step*z into one fma; the JAX package's ``color_substep``
jitted alone does the same in the same cells (printed beside it), and
``run_sweeps`` does not (check 1 is bit for bit).
Prints one line per check and exits non-zero on a failure.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mcjax.core.config import SimConfig as JaxConfig  # noqa: E402
from mcjax.core.state import init_state as jax_init_state  # noqa: E402
from mcjax.models.potentials import LennardJones as JaxLJ  # noqa: E402
from mcjax.ops import cells as jcells  # noqa: E402
from mcjax.ops import sweep as jsweep  # noqa: E402
from mcjax.ops.pallas_sweep import make_fused_substep  # noqa: E402

import mcjax_torch as mt  # noqa: E402
from mcjax_torch.ops import cells, cuda_substep  # noqa: E402

KW = dict(dim=3, n_atoms=500, box_length=10.0, cells_per_side=4, nmax=24,
          n_moves=3, proposal="gaussian", step_size=0.2, beta=0.5, seed=0)
JCFG, CFG = JaxConfig(**KW), mt.SimConfig(**KW)
JPOT, POT = JaxLJ(r_cut=2.5), mt.LennardJones(r_cut=2.5)
NEAR_TIE, DE_REL, DE_ABS = 1e-5, 1e-5, 1e-4
N_SWEEPS = 3


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def compare_substep(color, pos, occ, draws, want
                    ) -> tuple[bool, int, int, int]:
    """The port's plain sub-step against a JAX result (own, dE, acc, prop):
    (passed, cells that differ, near-tie cells, cells that differ by at most
    one ulp)."""
    rec = {}
    own, de, acc, prop = cuda_substep.color_substep(
        CFG, POT, color, torch.from_numpy(np.array(pos)),
        torch.from_numpy(np.array(occ)),
        *(torch.from_numpy(np.array(a).reshape(s)) for a, s in zip(
            draws, [(CFG.n_moves, *CFG.block_shape),
                    (CFG.n_moves, 3, *CFG.block_shape),
                    (CFG.n_moves, *CFG.block_shape)])), rec)
    own_w, de_w, acc_w, prop_w = (np.asarray(x) for x in want)
    differs = (bits(own.numpy()) != bits(own_w)).any(axis=(0, 1))
    ulp = np.abs(bits(own.numpy()).astype(np.int64)
                 - bits(own_w).astype(np.int64)).max(axis=(0, 1)) <= 1
    ties = (rec["margin"] <= NEAR_TIE).numpy()
    ok = not (differs & ~ties & ~ulp).any() and int(prop) == int(prop_w)
    if not (differs & ~ulp).any():
        ok = ok and int(acc) == int(acc_w) and abs(float(de) - float(de_w)) \
            <= DE_REL * abs(float(de_w)) + DE_ABS
    return ok, int(differs.sum()), int(ties.sum()), int((differs & ulp).sum())


def check_run_sweeps(st0) -> bool:
    log = []

    def record(cfg, pot, color, pos, occ, key, shift_fn, beta, block_offset):
        out = jsweep.color_substep(cfg, pot, color, pos, occ, key, shift_fn,
                                   beta, block_offset)
        draws = jsweep.substep_randoms(cfg, key, cfg.block_shape)
        jax.debug.callback(lambda c, *a: log.append((c, *map(np.array, a))),
                           color, *draws, ordered=True)
        return out

    def record_shift(cfg, pos, occ, axis, d, shift_fn, block_offset):
        jax.debug.callback(lambda *a: log.append(tuple(map(np.array, a))),
                           axis, d, ordered=True)
        return jcells.shift_rebin(cfg, pos, occ, axis, d, shift_fn,
                                  block_offset)

    want, wm = jsweep.run_sweeps(JCFG, JPOT, st0, N_SWEEPS)
    rec_run = jax.jit(lambda s: jax.lax.scan(lambda c, _: jsweep.mc_sweep(
        JCFG, JPOT, c, substep_fn=record, shift_rebin_fn=record_shift), s,
        length=N_SWEEPS))
    rec_st, _ = rec_run(st0)
    jax.effects_barrier()
    same = np.array_equal(bits(rec_st.pos), bits(want.pos))
    per_sweep = [log[9 * s:9 * s + 9] for s in range(N_SWEEPS)]

    class Replay:
        def schedule(self, cfg, sweep):
            subs, (axis, d) = per_sweep[sweep][:8], per_sweep[sweep][8]
            perm = torch.tensor([int(e[0]) for e in subs], dtype=torch.int32)
            return (perm, torch.from_numpy(axis).to(torch.int32),
                    torch.from_numpy(d))

        def substep(self, cfg, sweep, i, need_acc):
            return tuple(torch.from_numpy(a) for a in per_sweep[sweep][i][1:])

    start = mt.init_state(CFG, "cpu", cells.stratified_positions(CFG))
    got, m = mt.run_sweeps(CFG, POT, start, N_SWEEPS, Replay())
    ok = (same and np.array_equal(bits(got.pos.numpy()), bits(want.pos))
          and np.array_equal(got.occ.numpy(), np.asarray(want.occ))
          and np.array_equal(m.accepted.numpy(), np.asarray(wm.accepted))
          and np.array_equal(m.proposed.numpy(), np.asarray(wm.proposed))
          and np.allclose(m.delta_e.numpy(), np.asarray(wm.delta_e),
                          rtol=DE_REL, atol=DE_ABS))
    print(f"run_sweeps, {N_SWEEPS} sweeps with shifts: "
          f"{'equal' if ok else 'DIFFERENT'} (recorded run equals jitted "
          f"run_sweeps: {same}); accepted {m.accepted.tolist()}, dE port "
          f"{m.delta_e.tolist()} mcjax {np.asarray(wm.delta_e).tolist()}")
    return ok


def check_k5(st0) -> bool:
    fused = make_fused_substep(8, 128, interpret=True, slot_group=4,
                               frozen_cache=True)
    ok_all = True
    for color, seed in ((0, 11), (5, 12)):
        key = jax.random.key(seed)
        k5 = jax.jit(lambda p, o, k, c=color: fused(JCFG, JPOT, c, p, o, k))
        want = k5(st0.pos, st0.occ, key)
        draws = jsweep.substep_randoms(JCFG, key, JCFG.block_shape)
        ok, n_diff, n_ties, n_ulp = compare_substep(color, st0.pos, st0.occ,
                                                    draws, want)
        xla = jax.jit(partial(jsweep.color_substep, JCFG, JPOT, color))(
            st0.pos, st0.occ, key)
        _, x_diff, _, x_ulp = compare_substep(color, st0.pos, st0.occ, draws,
                                              xla)
        print(f"K5 _fused_core (frozen cache, interpret) color {color}: "
              f"{'equal' if ok else 'DIFFERENT'} outside near ties and "
              f"one-ulp cells; cells differing {n_diff} (near-tie cells "
              f"{n_ties}, within one ulp {n_ulp}); XLA color_substep jitted "
              f"alone: cells differing {x_diff}, within one ulp {x_ulp}; dE "
              f"K5 {float(want[1])}, accepted {int(want[2])} of "
              f"{int(want[3])}")
        ok_all = ok_all and ok
    return ok_all


def main() -> int:
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    st0 = jax_init_state(JCFG, positions=jcells.stratified_positions(JCFG))
    ok = check_run_sweeps(st0)
    ok = check_k5(st0) and ok
    print(f"{'ok' if ok else 'FAILED'} in {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
