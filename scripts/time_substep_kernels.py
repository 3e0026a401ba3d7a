#!/usr/bin/env python3
"""Time the port's hand-written kernels alone, for one tree of the repository.

    python3 scripts/time_substep_kernels.py [--kernels energetic disks shift]
                                            [--workloads lj3d ka3d]
                                            [--forms nvt npt field philox]
                                            [--sweeps 30] [--tree DIR]
                                            [--label NAME]

Builds the CUDA kernels of the tree ``--tree`` (by default the tree this
script lies in) and times, with that tree's ``mcjax_torch``:

* ``energetic``: each energetic workload at N = 1,000,000 set up as
  ``chip_smoke.py`` does (``mcjax_torch.bench.build_lj3d`` /
  ``build_ka3d``, 3 warm-up sweeps from a fixed seed), the sub-step kernel
  at every color of the next sweep, each color on its own copy of the
  state, in each form of ``--forms`` (``nvt``, the default; ``npt`` at
  box scale 0.999; ``field`` under a linear field g = 0.1 on the last
  axis; ``philox`` with in-kernel draws at ih_k 8, the draws' key fixed);
  with ``--sweeps N`` also the workload's bench run (N warm-up and N
  timed sweeps);
* ``disks``: the 2D sub-step kernel at N = 1,048,576 (phi 0.5, nmax 7,
  n_moves 64, one sweep from the lattice, as ``chip_smoke.py``): the four
  sub-steps of a sweep, as one launch where the tree's wrapper takes a
  range of sub-steps (``cuda_substep.substeps``), else as four launches;
  for the range also the cells of one launch that took the overflow pass;
* ``shift``: the grid-shift kernel on the 2D state above and on the lj3d
  (3 planes) and ka3d (4 planes) states after 3 sweeps, on every axis.

Each time is the mean of 10 launches (or launch groups) by CUDA events,
after one warm-up, with the launches queued behind a 5 ms device sleep so
that the host's enqueue cost stays out of the kernels' times. Prints one
JSON line with the card's name and power limit.

It uses only the wrappers and ``mcjax_torch.bench``, which the parent
commits have too, so it times another checkout as well: to compare two
trees on one card, unpack the other under ``build/`` and run the script
with ``--tree`` on each in turns (A, B, B, A) in one chip call. The draws
of the warm-up sweeps and of the timed sub-steps come from
``CallOrderRandoms`` below, not from the tree's own providers, so two
trees whose host-random kernels agree time the same inputs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

WORKLOADS = {
    "lj3d": ("build_lj3d", 24, "launch_lj_kernel", 4, "run_bench_lj3d"),
    "ka3d": ("build_ka3d", 34, "launch_mix_kernel", 7, "run_bench_ka3d"),
}
REPS = 10
SLEEP_CYCLES = 10_000_000   # about 5 ms at the H100's boost clock


class CallOrderRandoms:
    """The schedule and sub-step draws from one ``torch.Generator``, in
    call order (the sweep and sub-step only fix shapes)."""

    def __init__(self, seed: int):
        self.generator = torch.Generator("cuda").manual_seed(seed)

    def schedule(self, cfg, sweep):
        g = self.generator
        perm = torch.randperm(cfg.n_colors, generator=g, device="cuda",
                              dtype=torch.int32)
        axis = torch.randint(0, cfg.dim, (), generator=g, device="cuda",
                             dtype=torch.int32)
        half_w = cfg.cell_width / 2.0
        d = torch.empty((), dtype=torch.float32, device="cuda").uniform_(
            -half_w, half_w, generator=g)
        return perm, axis, d

    def substep(self, cfg, sweep, i, need_acc):
        g = self.generator
        n_m, dim, bs = cfg.n_moves, cfg.dim, cfg.block_shape
        pick_u = torch.rand((n_m, *bs), generator=g, device="cuda")
        disp = torch.empty((n_m, dim, *bs), dtype=torch.float32,
                           device="cuda")
        if cfg.proposal == "gaussian":
            disp.normal_(0.0, cfg.step_size, generator=g)
        else:
            disp.uniform_(-cfg.step_size, cfg.step_size, generator=g)
        acc_u = (torch.rand((n_m, *bs), generator=g, device="cuda")
                 if need_acc else None)
        return pick_u, disp, acc_u


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, queued
    behind a device sleep so that the launches run back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def form_args(form: str, cfg, pot) -> dict:
    """The launch helper's keyword arguments of a kernel form."""
    from mcjax_torch.models import fields
    from mcjax_torch.ops import cuda_substep
    from mcjax_torch.ops.random import PhiloxKey
    if form == "npt":
        scale = torch.tensor(0.999, dtype=torch.float32, device="cuda")
        return {"s2": cuda_substep.scale_squared(scale, torch.float32,
                                                 "cuda")}
    if form == "field":
        field = fields.LinearField(g=0.1, axis=cfg.dim - 1)
        fp = cuda_substep.field_params(field, cfg.dim,
                                       getattr(pot, "is_mixture", False))
        origin = torch.zeros(cfg.dim, dtype=torch.float32, device="cuda")
        return {"fk": cuda_substep.FieldKernel(fp, origin)}
    if form == "philox":
        return {"ph": cuda_substep.philox_args(cfg, PhiloxKey(7, 3, 8),
                                               True)}
    return {}


def time_workload(name: str, sweeps: int, forms=("nvt",)) -> dict:
    import mcjax_torch as mt
    from mcjax_torch import bench
    from mcjax_torch.ops import cuda_substep
    build, nmax, launch_name, seed, run = WORKLOADS[name]
    cfg, pot, st = getattr(bench, build)(1_000_000, nmax, 60, seed=0,
                                         device="cuda")
    rnd = CallOrderRandoms(seed)
    st, _ = mt.run_sweeps(cfg, pot, st, 3, rnd)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    launch = getattr(cuda_substep, launch_name)
    de_map = torch.empty(cfg.block_shape, dtype=torch.float32, device="cuda")
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    draws = [rnd.substep(cfg, st.sweep, i, True)
             for i in range(cfg.n_colors)]
    out = {}
    for form in forms:
        kw = form_args(form, cfg, pot)
        per_color = []
        for i in range(cfg.n_colors):
            work = st.pos.clone()
            per_color.append(cuda_ms(
                lambda: launch(cfg, pot, work, st.occ, perm, i, *draws[i],
                               de_map, acc_map, **kw), REPS))
        key = "" if form == "nvt" else f"{form}_"
        out[key + "kernel_ms"] = sum(per_color) / len(per_color)
        out[key + "kernel_ms_per_color"] = per_color
    if sweeps:
        result, *_ = getattr(bench, run)(sweeps=sweeps)
        out.update(ms_per_sweep=result["ms_per_sweep"],
                   moves_per_s=result["value"])
    return out


def disk_state():
    """The 2D state, schedule and draws of ``chip_smoke.py``'s kernel
    check: N = 1,048,576 after one sweep."""
    import mcjax_torch as mt
    from mcjax_torch import bench
    cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, 64, seed=0,
                               device="cuda")
    rnd = CallOrderRandoms(1)
    st, _ = mt.run_sweeps(cfg, pot, st, 1, rnd)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, False)
             for i in range(cfg.n_colors)]
    return cfg, pot, st, perm, draws


def time_disks() -> dict:
    from mcjax_torch.ops import cuda_substep
    cfg, pot, st, perm, draws = disk_state()
    work = st.pos.clone()
    if hasattr(cuda_substep, "substeps"):      # one launch of a range
        counts = torch.zeros((len(draws), 2), dtype=torch.int64,
                             device="cuda")
        pick_us = [p for p, _, _ in draws]
        disps = [d for _, d, _ in draws]

        def sweep_substeps():
            cuda_substep.launch_kernel(cfg, pot, work, st.occ, perm, 0,
                                       pick_us, disps, counts)
        launches = 1
        stats = cuda_substep.kernel_stats(work.device)
        stats.zero_()
        sweep_substeps()
        overflow_cells = int(stats[0])
    else:                                       # one launch a color
        acc_map = torch.empty(cfg.block_shape, dtype=torch.int32,
                              device="cuda")

        def sweep_substeps():
            for i, (p, d, _) in enumerate(draws):
                cuda_substep.launch_kernel(cfg, pot, work, st.occ, perm, i,
                                           p, d, acc_map)
        launches = len(draws)
        overflow_cells = None
    return {"sweep_substeps_ms": cuda_ms(sweep_substeps, REPS),
            "launches": launches, "overflow_cells": overflow_cells}


def time_shifts() -> dict:
    import mcjax_torch as mt
    from mcjax_torch import bench
    from mcjax_torch.ops import cuda_shift
    cfg, _, st, _, _ = disk_state()
    states = {"disks": (cfg, st)}
    for name in WORKLOADS:
        build, nmax, _, seed, _ = WORKLOADS[name]
        ecfg, epot, est = getattr(bench, build)(1_000_000, nmax, 60, seed=0,
                                                device="cuda")
        rnd = CallOrderRandoms(seed)
        est, _ = mt.run_sweeps(ecfg, epot, est, 3, rnd)
        states[name] = (ecfg, est)
    out = {}
    for name, (scfg, sst) in states.items():
        outs = (torch.empty_like(sst.pos), torch.empty_like(sst.occ),
                torch.zeros((), dtype=torch.int32, device="cuda"))
        d = torch.tensor(0.3 * scfg.cell_width, dtype=torch.float32,
                         device="cuda")
        per_axis = []
        for ax in range(scfg.dim):
            a = torch.tensor(ax, dtype=torch.int32, device="cuda")
            per_axis.append(cuda_ms(lambda: cuda_shift.launch_kernel(
                scfg, sst.pos, sst.occ, a, d, *outs), REPS))
        out[name] = {"planes": sst.pos.shape[1],
                     "shift_ms": sum(per_axis) / len(per_axis),
                     "shift_ms_per_axis": per_axis}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--kernels", nargs="+", default=["energetic"],
                    choices=["energetic", "disks", "shift"])
    ap.add_argument("--workloads", nargs="+", default=list(WORKLOADS),
                    choices=list(WORKLOADS))
    ap.add_argument("--forms", nargs="+", default=["nvt"],
                    choices=["nvt", "npt", "field", "philox"])
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_substep_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from mcjax_torch import _build
    from mcjax_torch.ops import cuda_shift, cuda_substep
    _build.build_all([cuda_substep.LIB, cuda_substep.LIB_LJ,
                      cuda_substep.LIB_MIX, cuda_shift.LIB])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    res = {"label": args.label or args.tree, "card": smi}
    if "disks" in args.kernels:
        res["disks"] = time_disks()
    if "shift" in args.kernels:
        res["shift"] = time_shifts()
    if "energetic" in args.kernels:
        for name in args.workloads:
            res[name] = time_workload(name, args.sweeps, args.forms)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
