"""Benchmark of the port: MC trial moves/s on one GPU.

Counterpart of the repository's ``bench.py`` for two of its workloads, run
through the port's CUDA kernels, with the same JSON keys:

* ``--workload hard-disk`` (the default, bench.py's headline): 2D hard disks
  of diameter 1 at area fraction phi, cells about wfac diameters wide, so
  4 x 320 x 320 cells at the defaults; uniform proposals of step 0.18,
  n_moves 64, nmax 7, 100 sweeps.
* ``--workload lj3d`` (``bench.py --workload lj3d``, ``bench_lj3d``): 3D
  Lennard-Jones (r_cut 2.5, unshifted) at rho 0.8, beta 0.3, N = 1,000,000
  (L = 107.72, 42^3 cells of width 2.5648 in 8 colors of 21^3), stratified
  start, gaussian proposals of step 0.12, n_moves 60, nmax 24, 30 sweeps.

Timing uses CUDA events around a timed run of ``--sweeps`` sweeps that
follows a warm-up run of the same length.

    python -m mcjax_torch.bench [--workload {hard-disk,lj3d}] [--n N]
                                [--phi 0.5] [--wfac 2.0] [--nmax NMAX]
                                [--moves M] [--sweeps S] [--seed 0]

Prints ONE JSON line: metric, value, unit, vs_baseline (against the
reference's 2.25e4 trial moves/s, BASELINE.md), plus overflow, acceptance
and the device name.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.state import SimState, init_state
from mcjax_torch.models.potentials import HardSphere, LennardJones, Potential
from mcjax_torch.ops import cells
from mcjax_torch.ops.random import TorchRandoms
from mcjax_torch.ops.sweep import SweepMetrics, run_sweeps

REFERENCE_MOVES_PER_S = 2.25e4  # BASELINE.md


def build(n_atoms: int, phi: float, cell_width_factor: float, nmax: int,
          n_moves: int, seed: int = 0,
          device: str | torch.device | None = None
          ) -> tuple[SimConfig, HardSphere, SimState]:
    """The hard-disk system of bench.py's ``build``, on ``device``."""
    diameter = 1.0
    box = math.sqrt(n_atoms * math.pi * diameter**2 / 4.0 / phi)
    cps = int(box // (diameter * cell_width_factor))
    cps -= cps % 2
    cfg = SimConfig(dim=2, n_atoms=n_atoms, box_length=box,
                    cells_per_side=cps, nmax=nmax, n_moves=n_moves,
                    proposal="uniform", step_size=0.18, beta=1.0, seed=seed)
    pot = HardSphere(diameter)
    cfg.validate_against(pot.r_cut)
    return cfg, pot, init_state(cfg, device)


def build_lj3d(n_atoms: int, nmax: int, n_moves: int, seed: int = 0,
               device: str | torch.device | None = None
               ) -> tuple[SimConfig, LennardJones, SimState]:
    """The 3D LJ system of bench.py's ``bench_lj3d``, on ``device``: rho 0.8,
    cells at least r_cut = 2.5 wide (an even count per side), stratified
    start."""
    rho = 0.8
    box = (n_atoms / rho) ** (1.0 / 3.0)
    cps = int(box // 2.5)
    cps -= cps % 2
    cfg = SimConfig(dim=3, n_atoms=n_atoms, box_length=box,
                    cells_per_side=cps, nmax=nmax, n_moves=n_moves,
                    proposal="gaussian", step_size=0.12, beta=0.3, seed=seed)
    pot = LennardJones(r_cut=2.5)
    cfg.validate_against(pot.r_cut)
    dev = resolve_device(device)
    state = init_state(cfg, dev, cells.stratified_positions(cfg, dev))
    return cfg, pot, state


def timed_run(cfg: SimConfig, pot: Potential, state: SimState, sweeps: int,
              seed: int, label: str
              ) -> tuple[dict, SimState, SweepMetrics, SweepMetrics]:
    """Warm-up run of ``sweeps`` sweeps, then a timed run of as many, on the
    state's (CUDA) device. Returns (result dict, final state, warm-up
    metrics, timed-run metrics)."""
    dev = state.pos.device
    randoms = TorchRandoms(torch.Generator(dev).manual_seed(seed))
    state, warm = run_sweeps(cfg, pot, state, sweeps, randoms)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, m = run_sweeps(cfg, pot, state, sweeps, randoms)
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3

    proposed = int(m.proposed.sum())
    accepted = int(m.accepted.sum())
    moves_per_s = proposed / seconds
    result = {
        "metric": label,
        "value": moves_per_s,
        "unit": "moves/s",
        "vs_baseline": moves_per_s / REFERENCE_MOVES_PER_S,
        "n_moves": cfg.n_moves,
        "sweeps": sweeps,
        "seconds": seconds,
        "acceptance": accepted / max(proposed, 1),
        "overflow": bool(state.overflow),
        "device": torch.cuda.get_device_name(dev),
    }
    return result, state, warm, m


def run_bench(n_atoms: int = 1 << 20, phi: float = 0.5, wfac: float = 2.0,
              nmax: int = 7, n_moves: int = 64, sweeps: int = 100,
              seed: int = 0
              ) -> tuple[dict, SimConfig, HardSphere, SimState, SweepMetrics,
                         SweepMetrics]:
    """The hard-disk benchmark on the GPU (warm-up, then ``sweeps`` timed).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state = build(n_atoms, phi, wfac, nmax, n_moves, seed, dev)
    label = ("hard-disk MC trial moves/sec/chip (N=%d, phi=%.2f, cuda)"
             % (cfg.n_atoms, phi))
    result, state, warm, m = timed_run(cfg, pot, state, sweeps, seed, label)
    return result, cfg, pot, state, warm, m


def run_bench_lj3d(n_atoms: int = 1_000_000, nmax: int = 24,
                   n_moves: int = 60, sweeps: int = 30, seed: int = 0
                   ) -> tuple[dict, SimConfig, LennardJones, SimState,
                              SweepMetrics, SweepMetrics]:
    """The 3D LJ benchmark on the GPU (warm-up, then ``sweeps`` timed).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state = build_lj3d(n_atoms, nmax, n_moves, seed, dev)
    label = ("3D LJ MC trial moves/sec/chip (N=%d, rho=0.8, cuda)"
             % cfg.n_atoms)
    result, state, warm, m = timed_run(cfg, pot, state, sweeps, seed, label)
    return result, cfg, pot, state, warm, m


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("hard-disk", "lj3d"),
                    default="hard-disk")
    ap.add_argument("--n", type=int, default=None,
                    help="atoms (1048576 hard-disk, 1000000 lj3d)")
    ap.add_argument("--phi", type=float, default=0.5, help="hard-disk only")
    ap.add_argument("--wfac", type=float, default=2.0,
                    help="hard-disk cell width in diameters (>= 1)")
    ap.add_argument("--nmax", type=int, default=None, help="7 / 24")
    ap.add_argument("--moves", type=int, default=None, help="64 / 60")
    ap.add_argument("--sweeps", type=int, default=None, help="100 / 30")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.workload == "lj3d":
        result, *_ = run_bench_lj3d(args.n or 1_000_000, args.nmax or 24,
                                    args.moves or 60, args.sweeps or 30,
                                    args.seed)
    else:
        result, *_ = run_bench(args.n or 1 << 20, args.phi, args.wfac,
                               args.nmax or 7, args.moves or 64,
                               args.sweeps or 100, args.seed)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
