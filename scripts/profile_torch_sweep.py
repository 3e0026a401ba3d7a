#!/usr/bin/env python3
"""Where a sweep of the port's main path spends its time, on one GPU.

    python3 scripts/profile_torch_sweep.py [--workload {hard-disk,lj3d,ka3d}]
                                           [--moves 64 8] [--sweeps 10]
                                           [--rng {in-kernel,host}]
                                           [--tree DIR]

For each n_moves: builds the workload's system, as ``mcjax_torch.bench``
does (hard-disk: N = 1,048,576, phi 0.5, nmax 7, n_moves 64 and 8 by
default; lj3d: N = 1,000,000, rho 0.8, nmax 24, n_moves 60 by default, from
the stratified start; ka3d: the Kob-Andersen mixture at N = 1,000,000,
rho 1.2, nmax 34, n_moves 60 by default, from the stratified start), warms
up, then over ``--sweeps`` sweeps measures
  * wall ms per sweep (host clock around work that ends in a synchronize),
  * host ms per sweep to enqueue the work (host clock, no synchronize),
  * device busy ms per sweep and kernel time by name (torch.profiler),
  * PyTorch calls per sweep (the operators the run loop calls, not the
    ones they call in turn) and device kernels per sweep (torch.profiler),
and prints one JSON line per n_moves with the device idle share
1 - busy / wall. ``--rng`` picks the draws as ``mcjax_torch.bench`` does:
in-kernel (the sub-step kernels' Philox forms, ih_k 8 in 3D and 12 in 2D;
the default) or host draws (``TorchRandoms``), through
``mcjax_torch.bench.make_randoms``. ``--tree`` profiles another
checkout's ``mcjax_torch`` (by default the tree this script lies in; it
needs ``bench.make_randoms``), to compare with a parent commit in one chip
call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def measure(workload: str, n_moves: int, sweeps: int, rng: str) -> dict:
    from mcjax_torch import bench
    from mcjax_torch.ops.sweep import run_sweeps
    if workload == "lj3d":
        cfg, pot, st = bench.build_lj3d(1_000_000, 24, n_moves,
                                        device="cuda")
    elif workload == "ka3d":
        cfg, pot, st = bench.build_ka3d(1_000_000, 34, n_moves,
                                        device="cuda")
    else:
        cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, n_moves,
                                   device="cuda")
    rnd = bench.make_randoms(rng, 0, torch.device("cuda"),
                             bench.DEFAULT_IH_K[workload])
    st, _ = run_sweeps(cfg, pot, st, sweeps, rnd)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    st, m = run_sweeps(cfg, pot, st, sweeps, rnd)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, m = run_sweeps(cfg, pot, st, sweeps, rnd)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    kernels = 0
    for ev in prof.key_averages():            # kernels only, not their ops
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key[:60]
            by_name[name] = by_name.get(name, 0.0) + \
                ev.self_device_time_total / 1e3
            kernels += ev.count
    # PyTorch calls of the run loop: operators no other operator called.
    calls = sum(1 for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith("aten::") and ev.cpu_parent is None)
    busy = sum(by_name.values())
    wall_ms = 1e3 * t_wall / sweeps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "workload": workload,
        "n_moves": n_moves,
        "rng": rng,
        "wall_ms_per_sweep": wall_ms,
        "enqueue_ms_per_sweep": 1e3 * t_enqueue / sweeps,
        "device_busy_ms_per_sweep": (busy / sweeps) if busy else None,
        "device_idle_share": (1 - busy / sweeps / wall_ms) if busy else None,
        "torch_calls_per_sweep": calls / sweeps,
        "device_kernels_per_sweep": kernels / sweeps,
        "kernels_ms_per_sweep": {k: v / sweeps for k, v in top},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("hard-disk", "lj3d", "ka3d"),
                    default="hard-disk")
    ap.add_argument("--moves", type=int, nargs="+", default=None,
                    help="64 8 (hard-disk) / 60 (lj3d, ka3d)")
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--rng", choices=("in-kernel", "host"),
                    default="in-kernel")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sweep: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    moves = args.moves or ([64, 8] if args.workload == "hard-disk" else [60])
    for n_moves in moves:
        res = measure(args.workload, n_moves, args.sweeps, args.rng)
        res["card"] = smi
        res["tree"] = args.tree
        print(json.dumps(res))


if __name__ == "__main__":
    main()
