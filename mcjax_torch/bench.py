"""Headline benchmark of the port: hard-disk MC trial moves/s on one GPU.

Counterpart of the hard-disk path of the repository's ``bench.py``: the same
system (2D hard disks of diameter 1 at area fraction phi, cells about wfac
diameters wide, so 4 x 320 x 320 cells at the defaults; uniform proposals of
step 0.18) and the same JSON keys, run through
the port's CUDA kernels. Timing uses CUDA events around a timed run of
``--sweeps`` sweeps that follows a warm-up run of the same length.

    python -m mcjax_torch.bench [--n 1048576] [--phi 0.5] [--wfac 2.0]
                                [--nmax 7] [--moves 64] [--sweeps 100]
                                [--seed 0]

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
from mcjax_torch.models.potentials import HardSphere
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


def run_bench(n_atoms: int = 1 << 20, phi: float = 0.5, wfac: float = 2.0,
              nmax: int = 7, n_moves: int = 64, sweeps: int = 100,
              seed: int = 0
              ) -> tuple[dict, SimConfig, HardSphere, SimState, SweepMetrics]:
    """Warm-up run, then a timed run of ``sweeps`` sweeps on the GPU.

    Returns (result dict, cfg, pot, final state, timed-run metrics).
    """
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state = build(n_atoms, phi, wfac, nmax, n_moves, seed, dev)
    randoms = TorchRandoms(torch.Generator(dev).manual_seed(seed))

    state, _ = run_sweeps(cfg, pot, state, sweeps, randoms)   # warm-up
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
        "metric": "hard-disk MC trial moves/sec/chip (N=%d, phi=%.2f, %s)"
                  % (cfg.n_atoms, phi, "cuda"),
        "value": moves_per_s,
        "unit": "moves/s",
        "vs_baseline": moves_per_s / REFERENCE_MOVES_PER_S,
        "n_moves": n_moves,
        "sweeps": sweeps,
        "seconds": seconds,
        "acceptance": accepted / max(proposed, 1),
        "overflow": bool(state.overflow),
        "device": torch.cuda.get_device_name(dev),
    }
    return result, cfg, pot, state, m


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--phi", type=float, default=0.5)
    ap.add_argument("--wfac", type=float, default=2.0,
                    help="cell width in diameters (>= 1)")
    ap.add_argument("--nmax", type=int, default=7)
    ap.add_argument("--moves", type=int, default=64)
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    result, *_ = run_bench(args.n, args.phi, args.wfac, args.nmax, args.moves,
                           args.sweeps, args.seed)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
