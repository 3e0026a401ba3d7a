#!/usr/bin/env python3
"""Time the energetic sub-step kernels of the tree this script lies in.

    python3 scripts/time_substep_kernels.py [--workloads lj3d ka3d]
                                            [--sweeps 30] [--label NAME]

Builds the tree's CUDA kernels, sets up each workload at N = 1,000,000 as
``chip_smoke.py`` does (``mcjax_torch.bench.build_lj3d`` / ``build_ka3d``,
3 warm-up sweeps from a fixed seed), and times the sub-step kernel alone at
every color of the next sweep: 10 launches by CUDA events after one
warm-up, each color on its own copy of the state. With ``--sweeps N`` it also times the workload's
bench run (N warm-up and N timed sweeps). Prints one JSON line with the
card's name and power limit.

It uses only the wrappers ``launch_lj_kernel`` / ``launch_mix_kernel`` and
``mcjax_torch.bench``, so a copy of it runs in another checkout too: to
compare two trees on one card, unpack the other under ``build/`` and run
the script from each in turns (A, B, B, A) in one chip call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WORKLOADS = {
    "lj3d": ("build_lj3d", 24, "launch_lj_kernel", 4, "run_bench_lj3d"),
    "ka3d": ("build_ka3d", 34, "launch_mix_kernel", 7, "run_bench_ka3d"),
}
REPS = 10


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_workload(name: str, sweeps: int) -> dict:
    import mcjax_torch as mt
    from mcjax_torch import bench
    from mcjax_torch.ops import cuda_substep
    build, nmax, launch_name, seed, run = WORKLOADS[name]
    cfg, pot, st = getattr(bench, build)(1_000_000, nmax, 60, seed=0,
                                         device="cuda")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(seed))
    st, _ = mt.run_sweeps(cfg, pot, st, 3, rnd)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    launch = getattr(cuda_substep, launch_name)
    de_map = torch.empty(cfg.block_shape, dtype=torch.float32, device="cuda")
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    per_color = []
    for i in range(cfg.n_colors):
        draws = rnd.substep(cfg, st.sweep, i, True)
        work = st.pos.clone()
        per_color.append(cuda_ms(lambda: launch(cfg, pot, work, st.occ, perm,
                                                i, *draws, de_map, acc_map),
                                 REPS))
    out = {"kernel_ms": sum(per_color) / len(per_color),
           "kernel_ms_per_color": per_color}
    if sweeps:
        result, *_ = getattr(bench, run)(sweeps=sweeps)
        out.update(ms_per_sweep=result["ms_per_sweep"],
                   moves_per_s=result["value"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workloads", nargs="+", default=list(WORKLOADS),
                    choices=list(WORKLOADS))
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--label", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_substep_kernels: no CUDA device", file=sys.stderr)
        return 2
    from mcjax_torch import _build
    from mcjax_torch.ops import cuda_substep
    _build.build_all([cuda_substep.LIB_LJ, cuda_substep.LIB_MIX])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    res = {"label": args.label, "card": smi}
    for name in args.workloads:
        res[name] = time_workload(name, args.sweeps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
