"""Virial pressure of the lj3d and ka3d fluids at a small N, on the CPU.

The NPT runs of the port need a pressure for each workload. No full-width
NPT configuration exists in mcjax, so the pressure is taken from mcjax's own
virial estimator (``mcjax.utils.observables.virial_pressure_cells``, or
``mcjax.ops.mixture.virial_pressure_cells_mixture``) on an NVT run of the
same fluid (density, temperature, model, proposal) at a small N:

* lj3d: 3D Lennard-Jones, r_cut 2.5 unshifted, rho 0.8, beta 0.3;
* ka3d: Kob-Andersen 80:20 (shifted), rho 1.2, T 0.8.

The virial has no term for the truncation, so an NPT run at this pressure
may settle at a slightly different density.

    JAX_PLATFORMS=cpu python tools/npt_pressure.py --workload lj3d \
        [--n 4000] [--equil 300] [--blocks 10] [--block-sweeps 20]

Prints one JSON line: the mean pressure over the blocks and its standard
error (block means), with the run's size.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mcjax.core.config import SimConfig  # noqa: E402
from mcjax.core.state import init_state  # noqa: E402
from mcjax.models.mixtures import kob_andersen  # noqa: E402
from mcjax.models.potentials import LennardJones  # noqa: E402
from mcjax.ops.cells import stratified_positions  # noqa: E402
from mcjax.ops.mixture import (init_mixture_state,  # noqa: E402
                               run_sweeps_mixture,
                               virial_pressure_cells_mixture)
from mcjax.ops.sweep import run_sweeps  # noqa: E402
from mcjax.utils.observables import virial_pressure_cells  # noqa: E402


def build(workload: str, n: int, n_moves: int, seed: int):
    """(cfg, pot, state, run, virial) of the workload at n atoms, with
    mcjax.bench's widths (rho, beta, model, step, cells at least r_cut
    wide)."""
    if workload == "lj3d":
        pot = LennardJones(r_cut=2.5)
        rho, beta, step = 0.8, 0.3, 0.12
    else:
        pot = kob_andersen()
        rho, beta, step = 1.2, 1.0 / 0.8, 0.09
    box = (n / rho) ** (1.0 / 3.0)
    cps = int(box // pot.r_cut)
    cps -= cps % 2
    nmax = max(8, math.ceil(3.0 * n / cps ** 3))
    cfg = SimConfig(dim=3, n_atoms=n, box_length=box, cells_per_side=cps,
                    nmax=nmax, n_moves=n_moves, proposal="gaussian",
                    step_size=step, beta=beta, seed=seed)
    cfg.validate_against(pot.r_cut)
    r0 = stratified_positions(cfg)
    if workload == "lj3d":
        state = init_state(cfg, positions=r0)
        run = run_sweeps
        virial = virial_pressure_cells
    else:
        spec = (jnp.arange(n) % 5 == 4).astype(jnp.int32)
        state = init_mixture_state(cfg, r0, spec, seed=seed)
        run = run_sweeps_mixture
        virial = virial_pressure_cells_mixture
    return cfg, pot, state, run, virial


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("lj3d", "ka3d"), default="lj3d")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--moves", type=int, default=60)
    ap.add_argument("--equil", type=int, default=300,
                    help="NVT sweeps before the first sample")
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--block-sweeps", type=int, default=20,
                    help="sweeps per block; P is sampled after each sweep")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    cfg, pot, st, run, virial = build(args.workload, args.n, args.moves,
                                      args.seed)
    one = jax.jit(lambda s: run(cfg, pot, s, 1))
    pressure = jax.jit(lambda p, o: virial(cfg, pot, p, o, cfg.beta))
    for _ in range(args.equil):
        st, _ = one(st)
    means, acc = [], []
    for _ in range(args.blocks):
        ps = []
        for _ in range(args.block_sweeps):
            st, m = one(st)
            ps.append(float(pressure(st.pos, st.occ)))
            acc.append(float(jnp.sum(m.accepted)) / float(jnp.sum(m.proposed)))
        means.append(float(np.mean(ps)))
    means = np.array(means)
    print(json.dumps({
        "workload": args.workload, "n_atoms": cfg.n_atoms,
        "box_length": cfg.box_length, "cells_per_side": cfg.cells_per_side,
        "nmax": cfg.nmax, "n_moves": cfg.n_moves, "beta": cfg.beta,
        "equil_sweeps": args.equil, "blocks": args.blocks,
        "block_sweeps": args.block_sweeps,
        "pressure": float(means.mean()),
        "pressure_stderr": float(means.std(ddof=1) / math.sqrt(len(means))),
        "block_means": means.tolist(), "acceptance": float(np.mean(acc)),
        "overflow": bool(st.overflow), "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
