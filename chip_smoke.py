#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``mcjax_torch/csrc`` with nvcc (one nvcc per source, all started together)
and checks three paths, each through the user's entry point
(``mcjax_torch.bench``):

* 2D hard disks (N = 1,048,576, phi 0.5, nmax 7, n_moves 64 and 8): each
  kernel held bit for bit against its plain PyTorch version at full size
  (the sub-step kernel as one launch of a sweep's four sub-steps against
  four plain sub-steps), a small run through the kernels against the plain
  CPU path fed the same random numbers, then the main path (one sub-step
  launch a sweep) with launch counts, overflow, particle count, overlaps
  and acceptance checked; the sub-step kernel's launch shape, cooperative
  grid and overflow-pass cells are printed.
* 3D Lennard-Jones (N = 1,000,000, rho 0.8, nmax 24, n_moves 60): the LJ
  sub-step kernel against its plain version for all 8 colors at full size
  after a few sweeps (bit for bit outside cells where a decision came
  within a relative NEAR_TIE of a tie, whose count is printed; dE within
  DE_REL + DE_ABS), the 3D shift kernel bit for bit for 3 axes x 2 signs, a
  small run through the kernels against the plain CPU path, then the main
  path (30 + 30 sweeps) with launch counts, overflow, N, ``validate_state``
  and the energy anchor (summed dE against the float64 total-energy
  difference, within ANCHOR_REL). For the sub-step kernel it also prints
  its launch shape (registers, shared memory, resident warps an SM, staged
  slots a warp), the full pair terms one sub-step evaluated beside the
  count the bound takes, and the cells that took its overflow pass, on the
  timing input and over the main path.
* the Kob-Andersen 80:20 mixture, ka3d (N = 1,000,000, rho 1.2, nmax 34,
  n_moves 60): the mixture sub-step kernel against its plain version for
  all 8 colors at full size under the same near-tie rule, the shift kernel
  carrying the species plane (4 planes) bit for bit for 3 axes x 2 signs, a
  small run (4,500 atoms) through the kernels against the plain CPU path,
  then the main path (100 + 100 sweeps) with launch counts, overflow, N,
  the A and B populations (800,000 / 200,000), ``validate_state`` and the
  energy anchor; the same shape and health lines as lj3d.
* the NPT ensemble (``mcjax_torch.ops.npt``): the NPT (scale^2) form of
  each sub-step kernel against its plain version at s = 1, 0.999 and
  1.001 on the 1M states above (2D bit for bit; lj3d and ka3d under the
  near-tie rule), and at s = 1 against the NVT kernel bit for bit; a 2D
  NPT small run through the kernels against the plain CPU path fed the
  same random numbers; the hard-disk equation of state (256 disks at
  phi* 0.4 under the Henderson pressure, 500 + 1,500 sweeps: the mean
  area fraction within 6 %); then the main path, lj3d at N = 1,000,000
  through ``mcjax_torch.bench.run_bench_npt`` (30 + 30 sweeps), and ka3d
  at a smaller depth (10 + 10), gated on the volume acceptance in (0, 1),
  launch counts (8 NPT sub-step launches and 1 shift a sweep), overflow,
  N, ``validate_state`` at the final scale and the carried energy against
  the float64 cell total at the final scale (ANCHOR_REL). It prints the
  NPT sweep's time beside the NVT sweep's, the volume move's time and
  peak memory, and the float32 against the float64 energy change of the
  warm-up run's volume moves.
* external fields (``mcjax_torch.ops.extfield``, FIELD): the field form of
  each sub-step kernel against its plain version at 1M on the states
  above, at frame origin 0 and near +-L/2 on every axis (2D walls alone
  bit for bit as one launch of a sweep; the energetic forms, 2D walls with
  gravity included, under the near-tie rule), and each field form with a
  null field against its NVT kernel bit for bit; a 2D slit small run
  through the kernels against the plain CPU path (positions, occupancies
  and the frame origin bit for bit); then three paths at 1M through
  ``mcjax_torch.bench.run_bench_field`` with mcjax's CLI flags: an lj3d
  slit pore under gravity (30 + 30 sweeps), ka3d under per-species
  gravity between walls with per-species contact diameters (10 + 10) and
  a hard-disk slit under gravity (20 + 20), gated on every sub-step
  launch being the field form, no particle in the walls, no overflow, N
  (and A / B), ``validate_state``, the acceptance, the carried dE against
  the float64 pair + field total difference (ANCHOR_REL) and a frame
  origin that moved. It prints each field sweep's time beside the NVT
  sweep's of this run, and each field form's kernel time beside its NVT
  form's on the same input.

* the in-kernel draws (mcjax's bench defaults, ``mcjax_torch.ops.random.
  PhiloxRandoms``): the Philox words of the kernels' generator
  (``csrc/philox.cuh``) against the plain ``philox4x32`` on 4,194,304
  counters and Random123's known-answer vectors, bit for bit; each Philox
  form at the 1M main-path shapes against its plain version
  (``PhiloxRandoms.move_draws``, then the plain sub-steps) and against
  its host-random kernel fed the same draws materialized on the card (2D:
  one launch of 4 sub-steps, pos, occ and counts bit for bit; lj3d and
  ka3d at ih_k 8: all 8 colors under the near-tie rule, dE against the
  plain version's; the kernels line's ``max_abs_err`` is the difference
  from the plain version); a 2D small run (N =
  4096, 5 sweeps) through the Philox form against the plain CPU path
  under the same PhiloxRandoms, bit for bit; the main paths at mcjax's
  bench defaults, in the Philox form (2D at n_moves 64 and 8, lj3d and
  ka3d at ih_k 8, as deep as their host-draw paths), under the same gates
  as those paths and timed beside them; a resume (2 + 2 sweeps against 4,
  bit for bit, 2D and lj3d at 1M, both providers); and the full
  statistical gate of the in-kernel draws (``mcjax_torch.utils.rng_gate``:
  hard disks 262,144, LJ 110,592, ka3d 87,793), printed check by check.
  Each Philox form is timed beside its host-random twin on the same state
  and draws, with its bound counting the Philox calls' INT32 operations.

Any failure raises and the script exits non-zero. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result. The second-to-last lines are a JSON object of per-kernel numbers
and the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations of one hard-disk pair test: 2 subtracts, 1 multiply, 1 fma
# (2), 1 compare.
OPS_PER_PAIR_TEST = 6
# Operations of one Lennard-Jones pair term: squared distance 8 (3
# subtracts, 1 multiply, 2 fmas), clamp 1, reciprocal 1, inv2 1, inv6 2,
# bracket fma 2, energy fma 2, cutoff compare and select 2, accumulate 1.
OPS_PER_LJ_TERM = 20
# Operations of one binary-mixture pair term: squared distance 8, clamp 1,
# reciprocal 1, two parameter selects by the slot's species 2, inv2 1,
# inv6 2, bracket fma 2, shift subtract 1, energy multiply 1, cutoff
# multiply, compare and select 3, accumulate 1.
OPS_PER_MIX_TERM = 23
# INT32 issue rate of one H100 SXM: 64 INT32 lanes an SM a clock (the
# Hopper architecture white paper) x 132 SMs x 1.98 GHz, the boost clock
# of the data sheet's float32 rate above.
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# INT32 operations of one Philox4x32-10 call, counted from the source
# (csrc/philox.cuh): 10 rounds of 2 mul.hi, 2 mul.lo and 2 three-input
# xors, and 2 key adds in 9 of them; and of one word's transform (a shift
# and a mask or a convert) into a uniform or a half-sum.
OPS_PER_PHILOX_CALL = 10 * 6 + 9 * 2
OPS_PER_PHILOX_WORD = 2
# The kernels line's rows of the energetic kernels' Philox forms.
PHILOX_ROWS = {"lj3d": "substep_lj_philox", "ka3d": "substep_mix_philox"}

# The NPT phases. Pressures: mcjax's virial pressure of each fluid at a
# small N (tools/npt_pressure.py: lj3d at N = 4,000 at its defaults, ka3d
# at N = 4,100 with --equil 1500 --block-sweeps 50);
# the ln V half-widths are set for a volume acceptance of about 0.2-0.6 at
# N = 1,000,000.
NPT_SCALES = (1.0, 0.999, 1.001)   # the scale^2 kernels' check points
NPT_TIME_SCALE = 0.999             # and the one they are timed at
NPT = {"lj3d": dict(pressure=10.645, dlnv_max=6e-4, sweeps=30),
       "ka3d": dict(pressure=7.668, dlnv_max=3e-4, sweeps=10)}
NPT_SMALL = dict(n=4096, sweeps=10, dlnv_max=2e-4)
HENDERSON = dict(n=256, phi=0.4, equil=500, sweeps=1500, dlnv_max=0.02,
                 rel=0.06)

MAIN_SWEEPS = 20      # 2D main path: warm-up and timed run, each
LJ_SWEEPS = 30        # lj3d main path: warm-up and timed run, each
LJ_WARMUP = 3         # lj3d sweeps before the kernel-vs-plain check
KA_SWEEPS = 100       # ka3d main path: warm-up and timed run, each
KA_WARMUP = 3         # ka3d sweeps before the kernel-vs-plain check
KA_POPULATIONS = [800_000, 200_000]   # A and B at N = 1,000,000
TIMED_LAUNCHES = 20   # kernel launches per timing loop
PLAIN_RUNS = 2        # plain-version calls per timing loop

NEAR_TIE = 1e-5       # |acc_u - a| <= NEAR_TIE * a, a = exp(-beta dE)
DE_REL, DE_ABS = 1e-5, 1e-4
ANCHOR_REL = 1e-3


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
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


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


class Recorder:
    """Provider that draws from TorchRandoms and keeps every tensor."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    def schedule(self, cfg, sweep):
        out = self.inner.schedule(cfg, sweep)
        self.log.append(out)
        return out

    def substep(self, cfg, sweep, i, need_acc):
        out = self.inner.substep(cfg, sweep, i, need_acc)
        self.log.append(out)
        return out

    def volume(self, cfg, sweep, dlnv_max):
        out = self.inner.volume(cfg, sweep, dlnv_max)
        self.log.append(out)
        return out


class Replay:
    """Provider that hands back a Recorder's tensors, on the CPU."""

    def __init__(self, log):
        self.log = [tuple(None if t is None else t.cpu() for t in item)
                    for item in log]

    def schedule(self, cfg, sweep):
        return self.log.pop(0)

    def substep(self, cfg, sweep, i, need_acc):
        return self.log.pop(0)

    def volume(self, cfg, sweep, dlnv_max):
        return self.log.pop(0)


def check_shift_kernel(cfg, st, d, cuda_shift) -> float:
    """The shift kernel against its plain version, bit for bit, on every
    axis and both signs of d; returns the largest absolute difference."""
    err = 0.0
    for ax in range(cfg.dim):
        for sign in (1, -1):
            a = torch.tensor(ax, dtype=torch.int32, device="cuda")
            dd = (sign * d.abs()).contiguous()
            p_pos, p_occ, p_ovf = cuda_shift.shift_rebin(cfg, st.pos, st.occ,
                                                         a, dd)
            k_pos, k_occ, k_ovf = cuda_shift.shift(cfg, st.pos, st.occ, a, dd)
            torch.cuda.synchronize()
            err = max(err, abs_err(k_pos, p_pos), abs_err(k_occ, p_occ))
            if not (bitwise_equal(k_pos, p_pos) and bitwise_equal(k_occ, p_occ)
                    and bool(k_ovf) == bool(p_ovf)):
                raise AssertionError(f"{cfg.dim}D shift kernel != plain, axis "
                                     f"{ax}, d {float(dd)}")
            print(f"{cfg.dim}D shift ({st.pos.shape[1]} planes) axis {ax} "
                  f"d {float(dd):+.6f}: bitwise equal, overflow "
                  f"{bool(k_ovf)}")
    return err


def check_kernels_against_plain(mt, cuda_substep, cuda_shift):
    """2D: each kernel vs its plain version, at 1M, same inputs: the
    sub-step kernel as one launch of the sweep's four sub-steps against
    four plain sub-steps."""
    from mcjax_torch import bench
    cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, 64, seed=0,
                               device="cuda")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(1))
    st, _ = mt.run_sweeps(cfg, pot, st, 1, rnd)        # leave the lattice
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    err = {}
    inputs = {}
    draws = [rnd.substep(cfg, st.sweep, i, False)
             for i in range(cfg.n_colors)]
    before = st.pos.clone()
    want = st.pos.clone()
    plain_counts = []
    for i, (pick_u, disp, _) in enumerate(draws):
        color = int(perm[i])
        own, _, acc, prop = cuda_substep.color_substep(cfg, pot, color, want,
                                                       st.occ, pick_u, disp)
        want[color] = own
        plain_counts.append((int(acc), int(prop)))
    _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, st.pos, st.occ, perm,
                                             draws)
    torch.cuda.synchronize()
    err["substep"] = abs_err(st.pos, want)
    if not bitwise_equal(st.pos, want):
        raise AssertionError("substep kernel (one launch, 4 sub-steps) != "
                             "4 plain sub-steps")
    k_counts = list(zip(k_acc.tolist(), k_prop.tolist()))
    if k_counts != plain_counts:
        raise AssertionError(f"substep counts {k_counts} != plain "
                             f"{plain_counts}")
    print(f"substep, one launch of 4 sub-steps (colors {perm.tolist()}): "
          f"bitwise equal to 4 plain sub-steps; accepted / proposed "
          f"{k_counts}")
    inputs["substep"] = (before, perm, draws)
    err["shift"] = check_shift_kernel(cfg, st, d, cuda_shift)
    inputs["shift"] = (st.pos, st.occ, axis, d)
    return cfg, pot, st, err, inputs


def check_small_run_against_cpu(mt):
    """2D: a small run through the kernels equals the plain CPU path fed
    the same random numbers."""
    from mcjax_torch import bench
    cfg, pot, st = bench.build(4096, 0.5, 2.0, 7, 16, device="cuda")
    rec = Recorder(mt.TorchRandoms(torch.Generator("cuda").manual_seed(2)))
    st_gpu, m_gpu = mt.run_sweeps(cfg, pot, st, 5, rec)
    st_cpu = mt.init_state(cfg, device="cpu")
    st_cpu, m_cpu = mt.run_sweeps(cfg, pot, st_cpu, 5, Replay(rec.log))
    for name in ("pos", "occ"):
        if not bitwise_equal(getattr(st_gpu, name).cpu(),
                             getattr(st_cpu, name)):
            raise AssertionError(f"small run: GPU {name} != CPU {name}")
    for name in ("accepted", "proposed", "overflow"):
        if not torch.equal(getattr(m_gpu, name).cpu(), getattr(m_cpu, name)):
            raise AssertionError(f"small run: GPU {name} != CPU {name}")
    print("small run (N=4096, 5 sweeps): GPU kernels == CPU plain path, "
          f"accepted {m_gpu.accepted.tolist()}")


def plain_substep(cuda_substep, pot):
    """The plain version of the energetic sub-step kernel for ``pot``."""
    if getattr(pot, "is_mixture", False):
        from mcjax_torch.ops.mixture import color_substep_mixture
        return color_substep_mixture
    return cuda_substep.color_substep


def compare_energetic_substep(cfg, pot, cuda_substep, pos, occ, perm, i,
                              draws, pos_plain, occ_plain) -> int:
    """One energetic sub-step through the kernel's wrapper (on ``pos``, in
    place) and the plain version on the CPU (on ``pos_plain``, in place;
    the same inputs), held to the near-tie rule. Returns the count of cells
    that differ, all near ties."""
    color = int(perm[i])
    dev = pos_plain.device
    rec = {}
    own, de, acc, prop = plain_substep(cuda_substep, pot)(
        cfg, pot, color, pos_plain, occ_plain, *(t.to(dev) for t in draws),
        rec)
    k_de, k_acc, k_prop = cuda_substep.substep(cfg, pot, pos, occ, perm, i,
                                               *draws)
    torch.cuda.synchronize()
    got = pos[color].to(dev)
    differs = (got.view(torch.int32) != own.view(torch.int32)).any(0).any(0)
    ties = rec["margin"] <= NEAR_TIE
    if bool((differs & ~ties).any()):
        raise AssertionError(f"substep kernel != plain outside near ties, "
                             f"color {color}: {int(differs.sum())} cells")
    if int(k_prop) != int(prop):
        raise AssertionError(f"proposals {int(k_prop)} != {int(prop)}")
    de_gap = abs(float(k_de) - float(de))
    if not bool(differs.any()):
        if int(k_acc) != int(acc) or de_gap > DE_REL * abs(float(de)) + DE_ABS:
            raise AssertionError(f"substep color {color}: accepted "
                                 f"{int(k_acc)} vs {int(acc)}, dE "
                                 f"{float(k_de)} vs {float(de)}")
    pos_plain[color] = own
    return int(differs.sum())


# For each energetic workload: its build function in mcjax_torch.bench and
# the nmax it runs at N = 1,000,000, the kernel launch helper, the seed and
# warm-up of its checks, the size of its small run, the keys of its
# sub-step and shift entries, its main-path run function, sweeps and
# sub-step library, and the A / B populations it must keep.
ENERGETIC = {
    "lj3d": dict(build="build_lj3d", nmax=24, launch="launch_lj_kernel",
                 seed=4, warmup=LJ_WARMUP, small=(4000, 24),
                 substep="substep_lj3d", shift="shift3d",
                 run="run_bench_lj3d", sweeps=LJ_SWEEPS, lib="substep_lj",
                 species=None),
    "ka3d": dict(build="build_ka3d", nmax=34, launch="launch_mix_kernel",
                 seed=7, warmup=KA_WARMUP, small=(4500, 34),
                 substep="substep_ka3d", shift="shift_ka3d",
                 run="run_bench_ka3d", sweeps=KA_SWEEPS, lib="substep_mix",
                 species=KA_POPULATIONS),
}


def check_energetic_against_plain(mt, cuda_substep, cuda_shift, workload):
    """An energetic workload at N = 1,000,000: the sub-step kernel vs its
    plain version for all 8 colors after a few sweeps, and the 3D shift
    kernel (with every plane the state carries)."""
    from mcjax_torch import bench
    w = ENERGETIC[workload]
    cfg, pot, st = getattr(bench, w["build"])(1_000_000, w["nmax"], 60,
                                              seed=0, device="cuda")
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(w["seed"]))
    st, _ = mt.run_sweeps(cfg, pot, st, w["warmup"], rnd)
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    n_diff = n_ties = 0
    worst_cell = worst_sub = 0.0
    inputs = {}
    for i in range(cfg.n_colors):
        draws = rnd.substep(cfg, st.sweep, i, True)
        color = int(perm[i])
        before = st.pos.clone()
        rec = {}
        own, de, acc, prop = plain(cfg, pot, color, before, st.occ, *draws,
                                   rec)
        de_map = torch.empty(cfg.block_shape, dtype=torch.float32,
                             device="cuda")
        acc_map = torch.empty(cfg.block_shape, dtype=torch.int32,
                              device="cuda")
        launch(cfg, pot, st.pos, st.occ, perm, i, *draws, de_map, acc_map)
        torch.cuda.synchronize()
        differs = (st.pos[color].view(torch.int32)
                   != own.view(torch.int32)).any(0).any(0)
        ties = rec["margin"] <= NEAR_TIE
        if bool((differs & ~ties).any()):
            raise AssertionError(f"{workload} substep kernel != plain outside"
                                 f" near ties, color {color}: "
                                 f"{int((differs & ~ties).sum())} cells")
        k_de = float(de_map.double().sum())
        k_acc = int(acc_map.sum())
        gap = abs(k_de - float(de))
        same = ~differs
        cell_gap = float((de_map - rec["de_cell"]).abs()[same].max())
        if not bool(differs.any()) and (
                k_acc != int(acc) or gap > DE_REL * abs(float(de)) + DE_ABS):
            raise AssertionError(f"{workload} substep color {color}: "
                                 f"accepted {k_acc} vs {int(acc)}, dE {k_de}"
                                 f" vs {float(de)}")
        n_diff += int(differs.sum())
        n_ties += int(ties.sum())
        worst_cell = max(worst_cell, cell_gap)
        worst_sub = max(worst_sub, gap)
        print(f"{workload} substep color {color}: equal outside near ties "
              f"(differing cells {int(differs.sum())}, near-tie cells "
              f"{int(ties.sum())}); accepted {k_acc} of {int(prop)}; dE "
              f"kernel {k_de:.6f} plain {float(de):.6f}; largest per-cell "
              f"dE difference {cell_gap:.3e}")
        inputs["substep"] = (before, perm, i, draws, rec)
    print(f"{workload} substep, 8 colors at N = 1,000,000: {n_diff} "
          f"differing cells, all near ties; near-tie cells {n_ties}; largest"
          f" dE difference per cell {worst_cell:.3e}, per sub-step "
          f"{worst_sub:.3e}")
    err = {w["substep"]: worst_cell,
           w["shift"]: check_shift_kernel(cfg, st, d, cuda_shift)}
    inputs["shift"] = (st.pos, st.occ, axis, d)
    return cfg, pot, st, err, inputs


def check_energetic_small_run_against_cpu(mt, cuda_substep, cuda_shift,
                                          workload):
    """A small energetic run, 5 sweeps: kernels on the GPU against the
    plain CPU path fed the same random numbers, sub-step by sub-step, held
    to the near-tie rule (a state that differs at a near tie is carried
    over from the GPU), every shift bit for bit."""
    from mcjax_torch import bench
    w = ENERGETIC[workload]
    n, nmax = w["small"]
    build = getattr(bench, w["build"])
    cfg, pot, st = build(n, nmax, 16, device="cuda")
    _, _, cpu = build(n, nmax, 16, device="cpu")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(w["seed"] + 1))
    pos, occ = st.pos, st.occ
    p_pos, p_occ = cpu.pos, cpu.occ
    if not (bitwise_equal(pos.cpu(), p_pos) and bitwise_equal(occ.cpu(),
                                                              p_occ)):
        raise AssertionError(f"{workload} small run: GPU start != CPU start")
    ties = 0
    for sweep in range(5):
        perm, axis, d = rnd.schedule(cfg, sweep)
        for i in range(cfg.n_colors):
            draws = rnd.substep(cfg, sweep, i, True)
            n_diff = compare_energetic_substep(cfg, pot, cuda_substep, pos,
                                               occ, perm, i, draws, p_pos,
                                               p_occ)
            if n_diff:
                ties += n_diff
                p_pos.copy_(pos.cpu())
        pos, occ, ovf = cuda_shift.shift(cfg, pos, occ, axis, d)
        p_pos, p_occ, p_ovf = cuda_shift.shift(cfg, p_pos, p_occ, axis.cpu(),
                                               d.cpu())
        if not (bitwise_equal(pos.cpu(), p_pos) and bitwise_equal(occ.cpu(),
                                                                   p_occ)
                and bool(ovf) == bool(p_ovf)):
            raise AssertionError(f"{workload} small run: shift {sweep} "
                                 "differs")
    print(f"{workload} small run (N={n}, 5 sweeps): GPU kernels == CPU plain"
          f" path outside near ties (differing cells {ties}); "
          f"{int(occ.sum())} particles")


def substep_bound_ms(cfg, st, inputs, cells, ops_per_test=OPS_PER_PAIR_TEST,
                     draws_read=True, int_ops=0) -> tuple[float, str]:
    """2D: least time for one launch of the sweep's sub-steps on this run's
    data: live slots read once and the active colors' live slots written
    once, occupancies and every sub-step's random inputs read once (none
    for the Philox form, ``draws_read`` False), the counts written; pair
    tests the occupancies need, every live slot of the own and neighbor
    cells for each move (``ops_per_test`` each; the NPT form's s^2 multiply
    adds one); ``int_ops`` INT32 operations (the in-kernel draws')."""
    _, perm, draws = inputs
    colors = [int(c) for c in perm[:len(draws)]]
    occ = st.occ
    live = int(occ.sum())
    own_live = sum(int(occ[c].sum()) for c in colors)
    nbytes = (4 * cfg.dim * live + occ.numel() * 4
              + 4 * cfg.dim * own_live + 16 * len(draws))
    if draws_read:
        nbytes += sum(4 * (p.numel() + d.numel()) for p, d, _ in draws)
    ops = 0
    for color in colors:
        _, nbr_occ = cells.neighbor_stack(cfg, st.pos, occ, color)
        own = occ[color].long()
        tests = torch.where(own > 0, (own - 1) + nbr_occ.long().sum(0), 0)
        ops += ops_per_test * cfg.n_moves * int(tests.sum())
    return bound(nbytes, ops, int_ops)


def bound_terms(cfg, st, inputs, cells) -> int:
    """The pair terms the frozen-cache algorithm needs for one energetic
    sub-step on this run's data: per cell occ x (frozen live slots) for the
    cache, and for each move that stays in its cell the frozen live slots
    plus 2 (occ - 1) own terms."""
    _, perm, i, _, rec = inputs
    color = int(perm[i])
    _, nbr_occ = cells.neighbor_stack(cfg, st.pos, st.occ, color)
    froz = nbr_occ.long().sum(0)
    own = st.occ[color].long()
    moves = rec["in_cell"].long()
    terms = own * froz + moves * (froz + 2 * (own - 1).clamp(min=0))
    return int(terms.sum())


def energetic_substep_bound_ms(cfg, st, inputs, cells, ops_per_term,
                               draws_read=True, int_ops=0
                               ) -> tuple[float, str]:
    """3D energetic sub-step: least time for one sub-step on this run's
    data. Bytes: live slots (every plane) and occupancies read once, the
    random inputs read once (none for the Philox forms, ``draws_read``
    False), the own live slots' coordinates and the two per-cell maps
    written once. Operations: ``bound_terms`` pair terms, and ``int_ops``
    INT32 operations (the in-kernel draws')."""
    _, perm, i, draws, _ = inputs
    color = int(perm[i])
    occ = st.occ
    nbytes = (4 * st.pos.shape[1] * int(occ.sum()) + 4 * occ.numel()
              + 4 * cfg.dim * int(occ[color].sum()) + 8 * cfg.cells_per_color)
    if draws_read:
        nbytes += sum(4 * t.numel() for t in draws)
    return bound(nbytes, ops_per_term * bound_terms(cfg, st, inputs, cells),
                 int_ops)


def shift_bound_ms(cfg, st) -> tuple[float, str]:
    """Live slots (every plane) read once, the whole output slab and
    occupancy written."""
    nbytes = (4 * st.pos.shape[1] * int(st.occ.sum()) + 4 * st.occ.numel()
              + 4 * st.pos.numel() + 4 * st.occ.numel())
    return bound(nbytes, 0)


def bound(nbytes: int, ops: int, int_ops: int = 0) -> tuple[float, str]:
    """max(bytes / bandwidth, float32 ops / float32 peak, INT32 ops / INT32
    issue rate): the two pipes issue side by side, so the larger operation
    time bounds them."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(ops / PEAK_F32_OPS_PER_S, int_ops / PEAK_INT32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def reset(libs) -> None:
    for lib in libs.values():
        lib.launches = 0
        lib.npt_launches = 0
        lib.field_launches = 0
        lib.philox_launches = 0


def expect_launches(libs, launches, substep_lib, per_sweep,
                    total_sweeps, npt: bool = False,
                    field: bool = False, philox: bool = False) -> None:
    """The run launched its sub-step kernel ``per_sweep`` times a sweep
    (once for 2D disks, once per color for the energetic models), each
    launch its NPT form if ``npt``, its field form if ``field``, its
    Philox form if ``philox`` and its NVT form if none, the shift once
    per sweep, and no other kernel."""
    want = {name: 0 for name in libs}
    want[substep_lib] = per_sweep * total_sweeps
    want["shift"] = total_sweeps
    if launches != want:
        raise AssertionError(f"launch counts {launches} for {total_sweeps} "
                             f"sweeps, want {want}")
    npt_launches = {name: lib.npt_launches for name, lib in libs.items()}
    want_npt = {name: 0 for name in libs}
    if npt:
        want_npt[substep_lib] = want[substep_lib]
    if npt_launches != want_npt:
        raise AssertionError(f"NPT-form launches {npt_launches}, want "
                             f"{want_npt}")
    field_launches = {name: lib.field_launches for name, lib in libs.items()}
    want_field = {name: 0 for name in libs}
    if field:
        want_field[substep_lib] = want[substep_lib]
    if field_launches != want_field:
        raise AssertionError(f"field-form launches {field_launches}, want "
                             f"{want_field}")
    philox_launches = {name: lib.philox_launches
                       for name, lib in libs.items()}
    want_philox = {name: 0 for name in libs}
    if philox:
        want_philox[substep_lib] = want[substep_lib]
    if philox_launches != want_philox:
        raise AssertionError(f"Philox-form launches {philox_launches}, want "
                             f"{want_philox}")


def run_main_path(mt, bench, libs, n_moves: int, stats: torch.Tensor,
                  rng: str = "host") -> dict:
    """2D main path through the user's entry point with ``rng`` draws
    (the in-kernel ones run the Philox form), with every kernel's launch
    count and the sub-step kernel's overflow-pass cells taken over exactly
    this run."""
    reset(libs)
    stats.zero_()
    result, cfg, pot, st, _, m = bench.run_bench(n_moves=n_moves,
                                                 sweeps=MAIN_SWEEPS, rng=rng)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    total_sweeps = 2 * MAIN_SWEEPS                   # warm-up + timed
    philox = rng == "in-kernel"
    expect_launches(libs, launches,
                    "substep_philox" if philox else "substep", 1,
                    total_sweeps, philox=philox)
    check_result(mt, cfg, pot, st, result)
    result.update(mt.validate_state(cfg, st, pot))   # incl. no overlap
    result["launches"] = launches
    result["overflow_cells"] = int(stats[0])
    result["cell_substeps"] = total_sweeps * cfg.n_colors * \
        cfg.cells_per_color
    result["ms_per_sweep"] = 1e3 * result["seconds"] / MAIN_SWEEPS
    print(json.dumps(result))
    return result


def run_energetic_main_path(mt, bench, libs, workload: str,
                            stats: torch.Tensor, rng: str = "host") -> dict:
    """An energetic main path (lj3d, ka3d) through the user's entry point
    with ``rng`` draws (the in-kernel ones run the Philox form, at the
    bench's ih_k): launch counts and the sub-step kernels' counters
    (overflow cells, full pair terms) over exactly this run, then the
    invariants (for ka3d the A and B populations too) and the energy
    anchor."""
    w = ENERGETIC[workload]
    cfg0, pot0, start = getattr(bench, w["build"])(1_000_000, w["nmax"], 60,
                                                   seed=0, device="cuda")
    e0 = float(mt.total_energy_cells(cfg0, pot0, start.pos, start.occ,
                                     torch.float64))
    del start
    reset(libs)
    stats.zero_()
    result, cfg, pot, st, warm, m = getattr(bench, w["run"])(
        sweeps=w["sweeps"], rng=rng)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    overflow_cells, full_terms = stats.tolist()
    total_sweeps = 2 * w["sweeps"]
    expect_launches(libs, launches, w["lib"], cfg.n_colors, total_sweeps,
                    philox=rng == "in-kernel")
    check_result(mt, cfg, pot, st, result)
    result.update(mt.validate_state(cfg, st, pot,
                                    expect_species=w["species"]))
    if w["species"] is not None and \
            [result["n_a"], result["n_b"]] != w["species"]:
        raise AssertionError(f"{workload}: A, B = {result['n_a']}, "
                             f"{result['n_b']}, want {w['species']}")
    e1 = float(mt.total_energy_cells(cfg, pot, st.pos, st.occ, torch.float64))
    de = float(warm.delta_e.double().sum() + m.delta_e.double().sum())
    gap = abs((e1 - e0) - de)
    if gap > ANCHOR_REL * max(1.0, abs(e1 - e0)):
        raise AssertionError(f"energy anchor: E {e0} -> {e1} "
                             f"(difference {e1 - e0}), summed dE {de}")
    n_sub = launches[w["lib"]]
    result.update(launches=launches, energy_start=e0, energy_end=e1, summed_de=de,
                  anchor_rel_gap=gap / max(1.0, abs(e1 - e0)),
                  overflow_cells=overflow_cells,
                  cell_launches=n_sub * cfg.cells_per_color,
                  full_terms_per_substep=full_terms / n_sub)
    print(json.dumps(result))
    return result


def check_result(mt, cfg, pot, st, result) -> None:
    if result["overflow"]:
        raise AssertionError("capacity overflow on the main path")
    if int(st.occ.sum()) != cfg.n_atoms:
        raise AssertionError(f"{int(st.occ.sum())} particles, want "
                             f"{cfg.n_atoms}")
    if not 0.0 < result["acceptance"] < 1.0:
        raise AssertionError(f"acceptance {result['acceptance']}")
    if not bool(torch.isfinite(st.pos).all()):
        raise AssertionError("non-finite positions")


def time_energetic(mt, cuda_substep, cuda_shift, cells, workload, cfg, pot,
                   st, inputs) -> tuple[dict, dict, float]:
    """An energetic workload's kernel and plain-version times at the
    main-path shapes (kernels alone, launches not counted), their bounds
    on this run's data, and the time of one sub-step's random draws; the
    sub-step kernel's NPT form is timed on the same input at scale
    NPT_TIME_SCALE. Prints the sub-step kernel's launch shape (both forms)
    and, for one sub-step on the timing input, the full pair terms it
    evaluated beside the count the bound takes, and the cells that took
    its overflow pass."""
    w = ENERGETIC[workload]
    sub, sh = w["substep"], w["shift"]
    before, perm, i, draws, _ = inputs["substep"]
    work = before.clone()
    de_map = torch.empty(cfg.block_shape, dtype=torch.float32, device="cuda")
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    launch = getattr(cuda_substep, w["launch"])
    scale = npt_scale(NPT_TIME_SCALE)
    s2 = cuda_substep.scale_squared(scale, torch.float32, "cuda")
    stats = cuda_substep.kernel_stats("cuda")
    need = bound_terms(cfg, st, inputs["substep"], cells)
    for name, form_s2 in ((sub, None), (sub + "_npt", s2)):
        shape = cuda_substep.kernel_shape(
            cuda_substep.kernel_library(cfg, pot), cfg.nmax,
            scaled=form_s2 is not None)
        work.copy_(before)
        stats.zero_()
        launch(cfg, pot, work, st.occ, perm, i, *draws, de_map, acc_map,
               form_s2)
        torch.cuda.synchronize()
        overflow_cells, full_terms = stats.tolist()
        print(f"{name} shape at nmax {cfg.nmax}: {shape['registers']} "
              f"registers, {shape['local_bytes']} bytes local, shared memory "
              f"{shape['static_smem']} static + {shape['dynamic_smem']} "
              f"dynamic bytes a block, {shape['warps_per_sm']} resident warps"
              f" an SM, {shape['staged_capacity']} staged slots a warp")
        print(f"{name} one sub-step: {full_terms} full pair terms evaluated, "
              f"the bound counts {need} ({full_terms / need:.4f} of them); "
              f"{overflow_cells} of {cfg.cells_per_color} cells took the "
              "overflow pass")
    work.copy_(before)
    plain = plain_substep(cuda_substep, pot)
    color = int(perm[i])
    times = {
        sub: cuda_ms(lambda: launch(cfg, pot, work, st.occ, perm, i, *draws,
                                    de_map, acc_map), TIMED_LAUNCHES),
        sub + "_plain": cuda_ms(lambda: plain(cfg, pot, color, before,
                                              st.occ, *draws), PLAIN_RUNS),
    }
    work.copy_(before)
    times[sub + "_npt"] = cuda_ms(lambda: launch(
        cfg, pot, work, st.occ, perm, i, *draws, de_map, acc_map, s2),
        TIMED_LAUNCHES)
    times[sub + "_npt_plain"] = cuda_ms(lambda: plain(
        cfg, pot, color, before, st.occ, *draws, scale=scale), PLAIN_RUNS)
    s_pos, s_occ, s_axis, s_d = inputs["shift"]
    outs = (torch.empty_like(s_pos), torch.empty_like(s_occ),
            torch.zeros((), dtype=torch.int32, device="cuda"))
    times[sh] = cuda_ms(lambda: cuda_shift.launch_kernel(
        cfg, s_pos, s_occ, s_axis, s_d, *outs), TIMED_LAUNCHES)
    times[sh + "_plain"] = cuda_ms(lambda: cuda_shift.shift_rebin(
        cfg, s_pos, s_occ, s_axis, s_d), PLAIN_RUNS)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(6))
    rng_ms = cuda_ms(lambda: rnd.substep(cfg, 0, 0, True), TIMED_LAUNCHES)
    ops = OPS_PER_MIX_TERM if workload == "ka3d" else OPS_PER_LJ_TERM
    bounds = {sub: energetic_substep_bound_ms(cfg, st, inputs["substep"],
                                              cells, ops),
              sub + "_npt": energetic_substep_bound_ms(
                  cfg, st, inputs["substep"], cells, ops + 1),
              sh: shift_bound_ms(cfg, st)}
    return times, bounds, rng_ms


def npt_scale(s: float) -> torch.Tensor:
    return torch.tensor(s, dtype=torch.float32, device="cuda")


def check_npt_disk_kernel(mt, cuda_substep, cfg, pot, st) -> float:
    """2D NPT form at 1M: one launch of a sweep's four sub-steps at each
    scale of NPT_SCALES against four plain sub-steps at that scale, bit
    for bit (positions and counts), and at s = 1 against the NVT kernel.
    Returns the largest absolute difference."""
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(21))
    err = 0.0
    for s in NPT_SCALES:
        scale = npt_scale(s)
        perm, _, _ = rnd.schedule(cfg, st.sweep)
        draws = [rnd.substep(cfg, st.sweep, i, False)
                 for i in range(cfg.n_colors)]
        before = st.pos.clone()
        want = st.pos.clone()
        plain_counts = []
        for i, (pick_u, disp, _) in enumerate(draws):
            color = int(perm[i])
            own, _, acc, prop = cuda_substep.color_substep(
                cfg, pot, color, want, st.occ, pick_u, disp, scale=scale)
            want[color] = own
            plain_counts.append((int(acc), int(prop)))
        nvt = before.clone()
        if s == 1.0:
            cuda_substep.substeps(cfg, pot, nvt, st.occ, perm, draws)
        _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, st.pos, st.occ,
                                                 perm, draws, scale=scale)
        torch.cuda.synchronize()
        err = max(err, abs_err(st.pos, want))
        k_counts = list(zip(k_acc.tolist(), k_prop.tolist()))
        if not bitwise_equal(st.pos, want) or k_counts != plain_counts:
            raise AssertionError(f"NPT substep kernel at s {s} != plain")
        if s == 1.0 and not bitwise_equal(st.pos, nvt):
            raise AssertionError("NPT substep kernel at s 1 != NVT kernel")
        nvt_note = " and to the NVT kernel" if s == 1.0 else ""
        print(f"substep NPT form at s {s}, one launch of 4 sub-steps: "
              f"bitwise equal to 4 plain sub-steps{nvt_note}; accepted / "
              f"proposed {k_counts}")
    return err


def check_npt_energetic(mt, cuda_substep, workload, cfg, pot, st) -> float:
    """An energetic NPT form at 1M: all 8 colors at each scale of
    NPT_SCALES against the plain version at that scale, under the near-tie
    rule, and at s = 1 against the NVT kernel bit for bit (positions and
    both per-cell maps). Returns the largest per-cell dE difference."""
    w = ENERGETIC[workload]
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(w["seed"] + 20))
    worst = 0.0
    bs = cfg.block_shape
    for s in NPT_SCALES:
        scale = npt_scale(s)
        s2 = cuda_substep.scale_squared(scale, torch.float32, "cuda")
        perm, _, _ = rnd.schedule(cfg, st.sweep)
        n_diff = n_ties = 0
        for i in range(cfg.n_colors):
            draws = rnd.substep(cfg, st.sweep, i, True)
            color = int(perm[i])
            before = st.pos.clone()
            rec = {}
            own, de, acc, prop = plain(cfg, pot, color, before, st.occ,
                                       *draws, rec, scale=scale)
            maps = [torch.empty(bs, dtype=t, device="cuda")
                    for t in (torch.float32, torch.int32) * 2]
            if s == 1.0:
                nvt = before.clone()
                launch(cfg, pot, nvt, st.occ, perm, i, *draws, *maps[2:])
            launch(cfg, pot, st.pos, st.occ, perm, i, *draws, *maps[:2], s2)
            torch.cuda.synchronize()
            de_map, acc_map = maps[:2]
            differs = (st.pos[color].view(torch.int32)
                       != own.view(torch.int32)).any(0).any(0)
            ties = rec["margin"] <= NEAR_TIE
            if bool((differs & ~ties).any()):
                raise AssertionError(f"{workload} NPT substep at s {s} != "
                                     f"plain outside near ties, color {color}")
            k_de, k_acc = float(de_map.double().sum()), int(acc_map.sum())
            if not bool(differs.any()) and (
                    k_acc != int(acc)
                    or abs(k_de - float(de)) > DE_REL * abs(float(de)) + DE_ABS):
                raise AssertionError(f"{workload} NPT substep at s {s}, color "
                                     f"{color}: accepted {k_acc} vs "
                                     f"{int(acc)}, dE {k_de} vs {float(de)}")
            if s == 1.0 and not (bitwise_equal(st.pos, nvt)
                                 and bitwise_equal(de_map, maps[2])
                                 and torch.equal(acc_map, maps[3])):
                raise AssertionError(f"{workload} NPT substep at s 1 != NVT "
                                     f"kernel, color {color}")
            worst = max(worst, float(
                (de_map - rec["de_cell"]).abs()[~differs].max()))
            n_diff += int(differs.sum())
            n_ties += int(ties.sum())
        print(f"{workload} substep NPT form at s {s}, 8 colors at N = "
              f"1,000,000: {n_diff} differing cells, all near ties; near-tie "
              f"cells {n_ties}"
              f"{'; bitwise equal to the NVT kernel' if s == 1.0 else ''}")
    print(f"{workload} substep NPT form: largest dE difference per cell "
          f"{worst:.3e}")
    return worst


def check_npt_small_run_against_cpu(mt) -> None:
    """2D NPT: a small run through the kernels equals the plain CPU path
    fed the same random numbers (volume draws included): positions,
    occupancies, log_scale and the volume decisions bit for bit. The box
    scale exp(log_scale) is computed by each device's own expf; its gap is
    printed in float32 ulps."""
    from mcjax_torch import bench
    n, sweeps, dlnv = NPT_SMALL["n"], NPT_SMALL["sweeps"], NPT_SMALL["dlnv_max"]
    phi = 0.5
    pressure = henderson_pressure(phi)
    cfg, pot, st = bench.build(n, phi, 2.0, 7, 16, device="cuda")
    rec = Recorder(mt.TorchRandoms(torch.Generator("cuda").manual_seed(22)))
    g_st, g_m = mt.run_npt(cfg, pot, mt.init_npt(st), pressure, sweeps, rec,
                           dlnv)
    c_st, c_m = mt.run_npt(cfg, pot, mt.init_npt(mt.init_state(cfg, "cpu")),
                           pressure, sweeps, Replay(rec.log), dlnv)
    for name, a, b in (("pos", g_st.sim.pos, c_st.sim.pos),
                       ("occ", g_st.sim.occ, c_st.sim.occ),
                       ("log_scale", g_st.log_scale, c_st.log_scale),
                       ("vol_accepted", g_m.vol_accepted, c_m.vol_accepted),
                       ("accepted", g_m.sweep.accepted, c_m.sweep.accepted),
                       ("proposed", g_m.sweep.proposed, c_m.sweep.proposed)):
        if not bitwise_equal(a.cpu(), b):
            raise AssertionError(f"NPT small run: GPU {name} != CPU {name}")
    ulps = abs(int(g_st.scale.cpu().view(torch.int32))
               - int(c_st.scale.view(torch.int32)))
    print(f"NPT small run (N={n}, {sweeps} sweeps, P {pressure:.4f}, dlnv_max "
          f"{dlnv}): GPU kernels == CPU plain path (pos, occ, log_scale, "
          f"volume decisions); {int(g_m.vol_accepted.sum())} volume moves "
          f"taken; exp(log_scale) GPU vs CPU: {ulps} ulps apart")
    # the card's expf and logf against the CPU's on the arguments NPT meets
    g = torch.Generator().manual_seed(24)
    for name, fn, x in (
            ("exp", torch.exp, (torch.rand(1 << 20, generator=g) - 0.5) * 0.1),
            ("log", torch.log, torch.rand(1 << 20, generator=g)
             .clamp_(min=1e-38))):
        gpu = fn(x.to("cuda")).cpu().view(torch.int32).long()
        cpu = fn(x).view(torch.int32).long()
        gap = (gpu - cpu).abs()
        print(f"float32 {name} on the card against the CPU over 2^20 "
              f"arguments: {int((gap > 0).sum())} differ, at most "
              f"{int(gap.max())} ulps")


def henderson_pressure(phi: float) -> float:
    """beta P of hard disks at area fraction phi, Henderson's equation of
    state, at beta 1."""
    return 4 * phi / math.pi * (1 + phi ** 2 / 8) / (1 - phi) ** 2


def check_henderson(mt, libs) -> dict:
    """tests/test_npt.py's hard-disk equation-of-state check on the card:
    256 disks under the Henderson pressure of phi* 0.4 settle at a mean
    area fraction within 6 % of 0.4. Every sweep launches the 2D kernel's
    NPT form once and the shift once (counted)."""
    n, phi = HENDERSON["n"], HENDERSON["phi"]
    box = math.sqrt(n * math.pi / 4 / phi)
    cps = int(box // 2.0) - int(box // 2.0) % 2
    cfg = mt.SimConfig(dim=2, n_atoms=n, box_length=box, cells_per_side=cps,
                       nmax=10, n_moves=4, proposal="uniform", step_size=0.15,
                       beta=1.0)
    pot = mt.HardSphere(1.0)
    pressure = henderson_pressure(phi)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(23))
    reset(libs)
    nst, _ = mt.run_npt(cfg, pot, mt.init_npt(mt.init_state(cfg, "cuda")),
                        pressure,
                        HENDERSON["equil"], rnd, HENDERSON["dlnv_max"])
    nst, m = mt.run_npt(cfg, pot, nst, pressure, HENDERSON["sweeps"], rnd,
                        HENDERSON["dlnv_max"])
    torch.cuda.synchronize()
    total = HENDERSON["equil"] + HENDERSON["sweeps"]
    launches = {name: lib.launches for name, lib in libs.items()}
    expect_launches(libs, launches, "substep", 1, total, npt=True)
    phi_mean = n * math.pi / 4 / float(m.volume.double().mean())
    mt.validate_state(cfg, nst.sim, pot, scale=float(nst.scale))
    if abs(phi_mean - phi) / phi >= HENDERSON["rel"]:
        raise AssertionError(f"Henderson: mean phi {phi_mean}, want {phi}")
    acc = float(m.vol_accepted.float().mean())
    print(f"hard-disk NPT equation of state (N={n}, beta P {pressure:.6f}): "
          f"mean phi {phi_mean:.6f} against {phi} (rel "
          f"{abs(phi_mean - phi) / phi:.4f}, limit {HENDERSON['rel']}); "
          f"volume acceptance {acc:.4f}; launches {launches}")
    return {"launches": launches["substep"], "phi_mean": phi_mean}


class VolumeAudit:
    """A volume hook: for each volume move, the float32 energy change the
    decision used (the total at s_new less the carried total) beside the
    float64 one (both totals in float64 on the same positions), split into
    the carried energy's gap from a fresh float32 total at s and the
    float32 totals' own dU gap; and the moves the one-ring contract
    refuses (s_new w < r_cut). The run's cfg and pot come with each call."""

    def __init__(self, mt):
        self.mt, self.cfg, self.pot = mt, None, None
        self.du32, self.du64, self.carry, self.s_new = [], [], [], []

    def __call__(self, cfg, pot, pos, occ, s, s_new, u_cur, u_new):
        self.cfg, self.pot = cfg, pot
        total = self.mt.total_energy_cells
        f64 = torch.float64
        u32 = total(cfg, pot, pos, occ, scale=s)
        self.du32.append(torch.stack([u_new - u_cur, u_new - u32]))
        self.carry.append(u_cur.double() - u32.double())
        self.du64.append(total(cfg, pot, pos, occ, f64, s_new)
                         - total(cfg, pot, pos, occ, f64, s))
        self.s_new.append(s_new)

    def summary(self) -> dict:
        du32 = torch.stack(self.du32).double().cpu()
        du64 = torch.stack(self.du64).cpu()
        gap = (du32[:, 0] - du64).abs()
        fresh = (du32[:, 1] - du64).abs()
        carry = torch.stack(self.carry).cpu().abs()
        s_new = torch.stack(self.s_new).cpu()
        return {"volume_moves_audited": len(self.du32),
                "du_f32_minus_f64_max": float(gap.max()),
                "du_f32_minus_f64_mean": float(gap.mean()),
                "du_fresh_f32_minus_f64_max": float(fresh.max()),
                "carried_minus_fresh_f32_max": float(carry.max()),
                "du_f64_abs_mean": float(du64.abs().mean()),
                "beta_du_gap_max": self.cfg.beta * float(gap.max()),
                "one_ring_refusals": int((s_new * self.cfg.cell_width
                                          < self.pot.r_cut).sum())}


def run_npt_main_path(mt, bench, libs, workload: str, stats: torch.Tensor,
                      nvt: dict) -> dict:
    """An NPT main path through the user's entry point
    (``bench.run_bench_npt``): launch counts over exactly this run (every
    sub-step launch the NPT form), the invariants at the final scale, the
    volume acceptance, the carried energy against the float64 total, the
    float32 against the float64 volume-move energy changes of the warm-up,
    and the volume move's time and peak memory on the final state."""
    w, npt = ENERGETIC[workload], NPT[workload]
    audit = VolumeAudit(mt)
    reset(libs)
    stats.zero_()
    result, cfg, pot, nst, warm, m = bench.run_bench_npt(
        workload, npt["pressure"], npt["dlnv_max"], sweeps=npt["sweeps"],
        volume_hook=audit)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    total_sweeps = 2 * npt["sweeps"]
    expect_launches(libs, launches, w["lib"], cfg.n_colors, total_sweeps,
                    npt=True)
    check_result(mt, cfg, pot, nst.sim, result)
    result.update(mt.validate_state(cfg, nst.sim, pot,
                                    expect_species=w["species"],
                                    scale=float(nst.scale)))
    if w["species"] is not None and \
            [result["n_a"], result["n_b"]] != w["species"]:
        raise AssertionError(f"{workload} NPT: A, B = {result['n_a']}, "
                             f"{result['n_b']}, want {w['species']}")
    if not 0.0 < result["volume_acceptance"] < 1.0:
        raise AssertionError(f"{workload} NPT: volume acceptance "
                             f"{result['volume_acceptance']}")
    if result["carried_energy_rel_err"] > ANCHOR_REL:
        raise AssertionError(f"{workload} NPT: carried energy "
                             f"{result['carried_energy']} against "
                             f"{result['energy_f64']}")
    result.update(audit.summary())
    # the volume move's cell total alone, on the final state
    s_new = nst.scale * math.exp(npt["dlnv_max"] / cfg.dim)
    total = mt.total_energy_cells
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vol_ms = cuda_ms(lambda: total(cfg, pot, nst.sim.pos, nst.sim.occ,
                                   scale=s_new), 3)
    peak = torch.cuda.max_memory_allocated() - base
    n_sub = launches[w["lib"]]
    result.update(launches=launches, overflow_cells=int(stats[0]),
                  cell_launches=n_sub * cfg.cells_per_color,
                  volume_move_ms=vol_ms, volume_move_peak_bytes=peak,
                  nvt_ms_per_sweep=nvt["ms_per_sweep"],
                  volume_move_share=vol_ms / result["ms_per_sweep"])
    print(json.dumps(result))
    return result


# The field phases (``mcjax_torch.ops.extfield``): for each workload the
# mcjax CLI flags of its field (``mcjax/cli.py:177-193``, built by
# ``bench.field_from_args``; LO and HI from the box), its depth, and its
# kernel row. lj3d: gravity 0.1 with walls 1.25 inside each face of z
# (centers within L/2 - 1.75, a gap of 3.5 > r_cut across the seam: a slit
# pore); ka3d: per-species gravity 0.1 / 0.05 with per-species contact
# diameters 1.0 / 0.8; hard disks: walls 1.0 inside each face of y with
# gravity 0.01, the energetic-over-hard-core form. The runs take the
# bench's field capacities (``bench.DEFAULT_FIELD_NMAX``).
FIELD = {
    "lj3d": dict(flags=dict(gravity=0.1), walls=(1.25, "1.0"), sweeps=30,
                 substep="substep_lj3d_field", lib="substep_lj"),
    "ka3d": dict(flags=dict(species_gravity="0.1,0.05"),
                 walls=(1.25, "1.0,0.8"), sweeps=10,
                 substep="substep_ka3d_field", lib="substep_mix"),
    "hard-disk": dict(flags=dict(gravity=0.01), walls=(1.0, "1.0"),
                      sweeps=20, substep="substep_field",
                      lib="substep_field"),
}
FIELD_SMALL = dict(n=4096, sweeps=5)


def field_ops_per_move(cuda_substep, field, dim: int, resolved: bool,
                       hard_core: bool) -> int:
    """Operations of one move's field work in a field form, counted from
    the terms the kernel gets (``cuda_substep.field_params``, evaluated by
    csrc/field.cuh): the physical wrap of each axis a term reads (5: two
    adds, two compares, a subtract) at the new position, and at the old
    one too when the field has energy; two compares for each walls term;
    each energetic term at both positions (4 an axis for a trap, 1 for a
    linear field's product, none for g = 1, 2 more for a species
    coupling, 1 to add each term after the first); the dE chain (2); and
    for hard disks the Metropolis test the field adds (3: the product by
    -beta, expf, the compare)."""
    fp = cuda_substep.field_params(field, dim, resolved)
    ops = 5 * bin(fp.axes).count("1") * (2 if fp.energetic else 1)
    terms = 0
    for t in fp.t[:fp.n]:
        if t.kind == 2:                     # walls
            ops += 2
            continue
        e = 4 * dim if t.kind == 0 else (0 if t.unit else 1)
        ops += 2 * (e + (2 if t.species else 0) + (1 if terms else 0))
        terms += 1
    if terms:
        ops += 2 + (3 if hard_core else 0)
    return ops


def path_field(bench, workload: str, cfg):
    """The field of a workload's field path, as its mcjax CLI flags give
    it."""
    f = FIELD[workload]
    inset, diam = f["walls"]
    half = cfg.box_length / 2.0
    args = dict(trap=None, gravity=None, species_gravity=None,
                field_axis=None,
                walls=f"{-half + inset!r},{half - inset!r},{diam}")
    args.update(f["flags"])
    return bench.field_from_args(SimpleNamespace(**args), cfg.dim,
                                 workload == "ka3d")


def field_origins(cfg) -> list[torch.Tensor]:
    """The frame origins of the field checks: 0, and one near +-L/2 on
    every axis (alternating signs), where the physical wrap flips."""
    edge = cfg.box_length / 2.0 - 1e-3
    return [torch.zeros(cfg.dim, device="cuda"),
            torch.tensor([edge * (-1) ** a for a in range(cfg.dim)],
                         dtype=torch.float32, device="cuda")]


def walls_only(field):
    """The slit walls of a composite field, alone."""
    from mcjax_torch.models import fields
    return fields.CompositeField(tuple(
        f for f in field.fields if isinstance(f, fields.SlitWalls)))


def check_field_disk_kernel(mt, bench, cuda_substep, cfg, pot, st) -> float:
    """2D field form at 1M (the disks' NVT check state): walls alone as one
    launch of a sweep's four sub-steps, bit for bit with four plain
    sub-steps (positions and counts); the path's field (walls and gravity:
    the energetic-over-hard-core form) as the path launches it, one launch
    of the four sub-steps, each under the near-tie rule with its dE per
    cell within DE_REL + DE_ABS (``held_against_plain_substeps``); each at
    origin 0 and near +-L/2. A null field (no term) equals the NVT kernel
    bit for bit.
    Returns the largest absolute position difference outside near ties."""
    from mcjax_torch.models import fields
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(31))
    field = path_field(bench, "hard-disk", cfg)
    walls = walls_only(field)
    err = 0.0
    for origin in field_origins(cfg):
        perm, _, _ = rnd.schedule(cfg, st.sweep)
        draws = [rnd.substep(cfg, st.sweep, i, True)
                 for i in range(cfg.n_colors)]
        before = st.pos.clone()
        want = st.pos.clone()
        plain_counts = []
        for i, (pick_u, disp, _) in enumerate(draws):
            color = int(perm[i])
            own, _, acc, prop = cuda_substep.color_substep(
                cfg, pot, color, want, st.occ, pick_u, disp, field=walls,
                origin=origin)
            want[color] = own
            plain_counts.append((int(acc), int(prop)))
        work = before.clone()
        _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, work, st.occ,
                                                 perm, draws, field=walls,
                                                 origin=origin)
        torch.cuda.synchronize()
        k_counts = list(zip(k_acc.tolist(), k_prop.tolist()))
        err = max(err, abs_err(work, want))
        if not bitwise_equal(work, want) or k_counts != plain_counts:
            raise AssertionError(f"substep field form, walls, origin "
                                 f"{origin.tolist()} != plain")
        print(f"substep field form, walls only, origin {origin.tolist()}, "
              f"one launch of 4 sub-steps: bitwise equal to 4 plain "
              f"sub-steps; accepted / proposed {k_counts}")
        # the path's field as the path launches it: one launch of the
        # sweep's four sub-steps, sub-step j reading acc_u[j] and writing
        # de_map[j]. Each sub-step writes only its color, so its input is
        # the start with the colors of the sub-steps before it taken from
        # the launch's output; each is held against one plain sub-step on
        # that input.
        work = before.clone()
        counts = torch.zeros((len(draws), 2), dtype=torch.int64,
                             device="cuda")
        de_map = torch.zeros((len(draws), *cfg.block_shape), device="cuda")
        fk = cuda_substep.FieldKernel(
            cuda_substep.field_params(field, cfg.dim, False), origin)
        cuda_substep.launch_field_kernel(cfg, pot, work, st.occ, perm, 0,
                                         draws, counts, de_map, fk)
        torch.cuda.synchronize()
        ties, e = held_against_plain_substeps(
            cuda_substep, cfg, pot, st.occ, perm, draws, field, origin,
            before, work, counts, de_map, "substep field form, walls + "
            f"gravity, origin {origin.tolist()}")
        err = max(err, e)
        print(f"substep field form, walls + gravity, origin "
              f"{origin.tolist()}, one launch of 4 sub-steps: equal to 4 "
              f"plain sub-steps outside near ties ({ties} differing cells, "
              "all near ties), dE per cell within DE_REL + DE_ABS")
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, False)
             for i in range(cfg.n_colors)]
    nvt, null = st.pos.clone(), st.pos.clone()
    cuda_substep.substeps(cfg, pot, nvt, st.occ, perm, draws)
    cuda_substep.substeps(cfg, pot, null, st.occ, perm, draws,
                          field=fields.CompositeField(()))
    torch.cuda.synchronize()
    if not bitwise_equal(nvt, null):
        raise AssertionError("substep field form, null field != NVT kernel")
    print("substep field form, null field: bitwise equal to the NVT kernel")
    return err


def held_against_plain_substeps(cuda_substep, cfg, pot, occ, perm, draws,
                                field, origin, before, after, counts,
                                de_map, what: str) -> tuple[int, float]:
    """A 2D field-form launch of sub-steps [0, n) that took ``before`` to
    ``after`` (its counts [n, 2] and per-cell dE maps [n, H, W]), held
    against the plain sub-steps: sub-step j's input is ``before`` with the
    colors of sub-steps 0..j-1 taken from ``after``, and its color in
    ``after`` must equal the plain sub-step's on that input outside near
    ties, its proposed count always, its accepted count where no cell
    differs, and every cell's dE where it does not differ within DE_REL
    + DE_ABS. Returns (differing cells, largest position difference
    outside them)."""
    inp = before.clone()
    ties, err = 0, 0.0
    for j, draw in enumerate(draws):
        color = int(perm[j])
        rec = {}
        own, _, acc, prop = cuda_substep.color_substep(
            cfg, pot, color, inp, occ, *draw, rec, field=field,
            origin=origin)
        got = after[color]
        differs = (got.view(torch.int32)
                   != own.view(torch.int32)).any(0).any(0)
        near = rec["margin"] <= NEAR_TIE
        if bool((differs & ~near).any()) or int(counts[j, 1]) != int(prop):
            raise AssertionError(f"{what}: sub-step {j} (color {color}) != "
                                 "plain outside near ties")
        if not bool(differs.any()) and int(counts[j, 0]) != int(acc):
            raise AssertionError(f"{what}: sub-step {j} accepted "
                                 f"{int(counts[j, 0])} vs {int(acc)}")
        same = ~differs
        want_de = rec["de_cell"][same]
        if bool(((de_map[j][same] - want_de).abs()
                 > DE_REL * want_de.abs() + DE_ABS).any()):
            raise AssertionError(f"{what}: sub-step {j} dE per cell != "
                                 "plain")
        if bool(same.any()):
            err = max(err, float((got - own).abs()[:, :, same].max()))
        ties += int(differs.sum())
        inp[color] = got
    return ties, err


def check_field_energetic_kernel(mt, bench, cuda_substep, workload, cfg, pot,
                                 st) -> float:
    """An energetic field form at 1M (the workload's NVT check state): all 8
    colors under the path's field at origin 0 and near +-L/2 against the
    plain version, under the near-tie rule; one color with a null field
    against the NVT kernel bit for bit (positions and both maps). Returns
    the largest per-cell dE difference outside near ties."""
    from mcjax_torch.models import fields
    w = ENERGETIC[workload]
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    field = path_field(bench, workload, cfg)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(w["seed"] + 30))
    bs = cfg.block_shape
    worst = 0.0
    for origin in field_origins(cfg):
        perm, _, _ = rnd.schedule(cfg, st.sweep)
        n_diff = n_ties = 0
        for i in range(cfg.n_colors):
            draws = rnd.substep(cfg, st.sweep, i, True)
            color = int(perm[i])
            before = st.pos.clone()
            rec = {}
            own, de, acc, prop = plain(cfg, pot, color, before, st.occ,
                                       *draws, rec, field=field,
                                       origin=origin)
            de_map = torch.empty(bs, dtype=torch.float32, device="cuda")
            acc_map = torch.empty(bs, dtype=torch.int32, device="cuda")
            launch(cfg, pot, st.pos, st.occ, perm, i, *draws, de_map,
                   acc_map, None, cuda_substep.FieldKernel(
                       cuda_substep.field_params(field, cfg.dim,
                                                 workload == "ka3d"), origin))
            torch.cuda.synchronize()
            differs = (st.pos[color].view(torch.int32)
                       != own.view(torch.int32)).any(0).any(0)
            near = rec["margin"] <= NEAR_TIE
            if bool((differs & ~near).any()):
                raise AssertionError(f"{workload} substep field form != plain"
                                     f" outside near ties, color {color}")
            k_de, k_acc = float(de_map.double().sum()), int(acc_map.sum())
            if not bool(differs.any()) and (
                    k_acc != int(acc)
                    or abs(k_de - float(de)) > DE_REL * abs(float(de)) + DE_ABS):
                raise AssertionError(f"{workload} substep field form, color "
                                     f"{color}: accepted {k_acc} vs "
                                     f"{int(acc)}, dE {k_de} vs {float(de)}")
            worst = max(worst, float(
                (de_map - rec["de_cell"]).abs()[~differs].max()))
            n_diff += int(differs.sum())
            n_ties += int(near.sum())
        print(f"{workload} substep field form, origin {origin.tolist()}, 8 "
              f"colors at N = 1,000,000: {n_diff} differing cells, all near "
              f"ties; near-tie cells {n_ties}")
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = rnd.substep(cfg, st.sweep, 0, True)
    maps = [torch.empty(bs, dtype=t, device="cuda")
            for t in (torch.float32, torch.int32) * 2]
    nvt, null = st.pos.clone(), st.pos.clone()
    launch(cfg, pot, nvt, st.occ, perm, 0, *draws, *maps[:2])
    launch(cfg, pot, null, st.occ, perm, 0, *draws, *maps[2:], None,
           cuda_substep.FieldKernel(cuda_substep.field_params(
               fields.CompositeField(()), cfg.dim, workload == "ka3d"),
               torch.zeros(cfg.dim, device="cuda")))
    torch.cuda.synchronize()
    if not (bitwise_equal(nvt, null) and bitwise_equal(maps[0], maps[2])
            and torch.equal(maps[1], maps[3])):
        raise AssertionError(f"{workload} substep field form, null field != "
                             "NVT kernel")
    print(f"{workload} substep field form: null field bitwise equal to the "
          f"NVT kernel; largest dE difference per cell {worst:.3e}")
    return worst


def check_field_small_run_against_cpu(mt, bench) -> None:
    """2D slit: a small run under the hard-disk path's field (walls and
    gravity, the energetic-over-hard-core form, one launch a sweep) equals
    the plain CPU path fed the same random numbers: positions,
    occupancies, the frame origin and the counts bit for bit, each sweep's
    dE within DE_REL + DE_ABS (summed in another order), and no particle
    in the walls. A decision within an ulp of a tie (expf against torch's
    exp) would break the bitwise gate; some 1e5 exp tests a run, each
    within an ulp with a chance of about 1e-8, make one unlikely."""
    from mcjax_torch.ops import extfield
    n, sweeps = FIELD_SMALL["n"], FIELD_SMALL["sweeps"]
    cfg, pot, st = bench.build(n, 0.5, 2.0, 7, 16, device="cuda")
    field = path_field(bench, "hard-disk", cfg)
    st = bench.slab_start(cfg, field, st, False)
    cpu = mt.state_from_numpy(*mt.state_to_numpy(st), device="cpu")
    rec = Recorder(mt.TorchRandoms(torch.Generator("cuda").manual_seed(32)))
    g_st, g_org, g_m = extfield.run_field_sweeps(
        cfg, pot, field, st, torch.zeros(2, device="cuda"), sweeps, rec)
    c_st, c_org, c_m = extfield.run_field_sweeps(
        cfg, pot, field, cpu, torch.zeros(2), sweeps, Replay(rec.log))
    for name, a, b in (("pos", g_st.pos, c_st.pos), ("occ", g_st.occ, c_st.occ),
                       ("origin", g_org, c_org),
                       ("accepted", g_m.accepted, c_m.accepted),
                       ("proposed", g_m.proposed, c_m.proposed)):
        if not bitwise_equal(a.cpu(), b):
            raise AssertionError(f"field small run: GPU {name} != CPU {name}")
    g_de, c_de = g_m.delta_e.cpu().double(), c_m.delta_e.double()
    if bool(((g_de - c_de).abs() > DE_REL * c_de.abs() + DE_ABS).any()):
        raise AssertionError(f"field small run: dE per sweep {g_de.tolist()}"
                             f" != CPU {c_de.tolist()}")
    bad = int(extfield.field_violations(cfg, field, g_st.pos, g_st.occ,
                                        g_org))
    if bad:
        raise AssertionError(f"field small run: {bad} particles in the walls")
    print(f"field small run (2D slit under walls and gravity, N={n}, "
          f"{sweeps} sweeps): GPU kernels == CPU plain path (pos, occ, "
          f"origin {g_org.tolist()}, counts; dE per sweep {g_de.tolist()})")


def field_substep_bound_ms(cfg, st, inputs, cells, field_energy: bool,
                           field_ops: int) -> tuple[float, str]:
    """2D field form: ``substep_bound_ms``'s bytes, with the acceptance
    uniforms and the per-cell dE maps when the field has energy, and its
    operations plus ``field_ops``, the field's over the sub-steps."""
    _, perm, draws = inputs
    colors = [int(c) for c in perm[:len(draws)]]
    occ = st.occ
    live = int(occ.sum())
    own_live = sum(int(occ[c].sum()) for c in colors)
    nbytes = (4 * cfg.dim * live + occ.numel() * 4
              + sum(4 * (p.numel() + d.numel()) for p, d, _ in draws)
              + 4 * cfg.dim * own_live + 16 * len(draws))
    if field_energy:
        nbytes += sum(4 * a.numel() for _, _, a in draws) \
            + 4 * cfg.cells_per_color * len(draws)
    ops = 0
    for color in colors:
        _, nbr_occ = cells.neighbor_stack(cfg, st.pos, occ, color)
        own = occ[color].long()
        tests = torch.where(own > 0, (own - 1) + nbr_occ.long().sum(0), 0)
        ops += OPS_PER_PAIR_TEST * cfg.n_moves * int(tests.sum())
    return bound(nbytes, ops + field_ops)


def time_field_disk(mt, bench, cuda_substep, cells, cfg, pot, st, inputs
                    ) -> tuple[dict, dict]:
    """The 2D field form's kernel and plain-version times on the NVT row's
    input under the path's field (origin near +-L/2), beside the NVT form
    timed again the same way, and its bound; prints its launch shape."""
    times, bounds = {}, {}
    before, perm, draws = inputs["substep"]
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(33))
    fdraws = [(p, d, rnd.substep(cfg, 0, i, True)[2])
              for i, (p, d, _) in enumerate(draws)]
    field = path_field(bench, "hard-disk", cfg)
    origin = field_origins(cfg)[1]
    fk = cuda_substep.FieldKernel(cuda_substep.field_params(field, 2, False),
                                  origin)
    shape = cuda_substep.kernel_shape(cuda_substep.LIB, cfg.nmax,
                                      cfg.cells_per_color, field=True)
    print(f"substep_field shape at nmax {cfg.nmax}: {shape['registers']} "
          f"registers, {shape['local_bytes']} bytes local, shared memory "
          f"{shape['static_smem']} static + {shape['dynamic_smem']} dynamic "
          f"bytes a block, {shape['warps_per_sm']} resident warps an SM; "
          f"cooperative grid {shape['grid_blocks']} blocks")
    work = before.clone()
    counts = torch.zeros((len(draws), 2), dtype=torch.int64, device="cuda")
    de_map = torch.zeros((len(draws), *cfg.block_shape), device="cuda")
    times["substep_field"] = cuda_ms(lambda: cuda_substep.launch_field_kernel(
        cfg, pot, work, st.occ, perm, 0, fdraws, counts, de_map, fk),
        TIMED_LAUNCHES)
    work.copy_(before)
    times["substep_field_nvt"] = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, 0, [d[0] for d in draws],
        [d[1] for d in draws], counts), TIMED_LAUNCHES)

    def plain_sweep():
        pos = before.clone()
        for j, draw in enumerate(fdraws):
            c = int(perm[j])
            pos[c] = cuda_substep.color_substep(cfg, pot, c, pos, st.occ,
                                                *draw, field=field,
                                                origin=origin)[0]
    times["substep_field_plain"] = cuda_ms(plain_sweep, PLAIN_RUNS)
    # the field's operations: field_ops_per_move for each move that stays
    # in its cell and out of the walls, as the plain sub-steps count them
    pos, moves = before.clone(), 0
    for j, draw in enumerate(fdraws):
        c, rec = int(perm[j]), {}
        pos[c] = cuda_substep.color_substep(cfg, pot, c, pos, st.occ, *draw,
                                            rec, field=field,
                                            origin=origin)[0]
        moves += int(rec["in_cell"].sum())
    bounds["substep_field"] = field_substep_bound_ms(
        cfg, st, (before, perm, fdraws), cells, True,
        moves * field_ops_per_move(cuda_substep, field, 2, False, True))
    return times, bounds


def time_field_energetic(mt, bench, cuda_substep, cells, workload, cfg, pot,
                         st, inputs) -> tuple[dict, dict]:
    """An energetic field form's kernel and plain-version times on its NVT
    row's input (``time_energetic``'s) under the path's field (origin near
    +-L/2), beside the NVT form timed again the same way, and its bound:
    the NVT form's pair terms on this input plus field_ops_per_move for
    each move that stays in its cell and out of the walls; prints its
    launch shape."""
    w, fw = ENERGETIC[workload], FIELD[workload]
    sub = fw["substep"]
    before, perm, i, draws, _ = inputs["substep"]
    field = path_field(bench, workload, cfg)
    origin = field_origins(cfg)[1]
    fk = cuda_substep.FieldKernel(cuda_substep.field_params(
        field, 3, workload == "ka3d"), origin)
    shape = cuda_substep.kernel_shape(cuda_substep.kernel_library(cfg, pot),
                                      cfg.nmax, field=True)
    print(f"{sub} shape at nmax {cfg.nmax}: {shape['registers']} "
          f"registers, {shape['local_bytes']} bytes local, shared memory"
          f" {shape['static_smem']} static + {shape['dynamic_smem']} "
          f"dynamic bytes a block, {shape['warps_per_sm']} resident "
          f"warps an SM, {shape['staged_capacity']} staged slots a warp")
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    work = before.clone()
    maps = (torch.empty(cfg.block_shape, device="cuda"),
            torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda"))
    color = int(perm[i])
    times = {
        sub: cuda_ms(lambda: launch(cfg, pot, work, st.occ, perm, i, *draws,
                                    *maps, None, fk), TIMED_LAUNCHES)}
    work.copy_(before)
    times[sub + "_nvt"] = cuda_ms(lambda: launch(
        cfg, pot, work, st.occ, perm, i, *draws, *maps), TIMED_LAUNCHES)
    rec = {}
    plain(cfg, pot, color, before, st.occ, *draws, rec, field=field,
          origin=origin)
    times[sub + "_plain"] = cuda_ms(lambda: plain(
        cfg, pot, color, before, st.occ, *draws, field=field, origin=origin),
        PLAIN_RUNS)
    ops = OPS_PER_MIX_TERM if workload == "ka3d" else OPS_PER_LJ_TERM
    b_ms, by = energetic_substep_bound_ms(cfg, st, (before, perm, i, draws,
                                                    rec), cells, ops)
    field_ms = 1e3 * int(rec["in_cell"].sum()) * field_ops_per_move(
        cuda_substep, field, 3, workload == "ka3d", False) \
        / PEAK_F32_OPS_PER_S
    return times, {sub: (b_ms + field_ms if by == "operations" else b_ms,
                         by)}


def replay_field_run(mt, bench, workload: str, cfg, pot, field,
                     sweeps: int, seed: int = 0):
    """A ``bench.run_bench_field`` run of ``sweeps`` sweeps in all (warm-up
    and timed), replayed from its start with its seed through
    ``extfield.field_sweep`` itself: ``TorchRandoms`` draws in call order
    and the kernels are deterministic, so the same calls give the same
    trajectory. Between sweeps it measures in float64 how much each grid
    shift changes the field's total: the shift rounds the stored float32
    coordinates and the float32 frame origin (the JAX package's frame),
    alike for every particle of a binade, which moves them against the
    field. A sweep's sub-steps update the state's positions in place and
    its shift writes new buffers, so after a shifting sweep the old
    state's positions are the ones the shift read. Returns (final state,
    final origin, summed shift changes)."""
    from mcjax_torch.ops import extfield

    def total(st, origin):
        return extfield.total_field_energy_cells(cfg, field, st.pos, st.occ,
                                                 origin, torch.float64)

    _, _, st, _ = bench.build_workload(workload, nmax=cfg.nmax,
                                       device="cuda")
    st = bench.slab_start(cfg, field, st, workload == "ka3d")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(seed))
    origin = torch.zeros(cfg.dim, device="cuda")
    jumps = 0.0
    for _ in range(sweeps):
        shift = (st.sweep + 1) % cfg.shift_every == 0
        new, new_origin, _ = extfield.field_sweep(cfg, pot, field, st,
                                                  origin, rnd)
        if shift:
            jumps += float(total(new, new_origin) - total(st, origin))
        st, origin = new, new_origin
    return st, origin, jumps


def run_field_main_path(mt, bench, libs, workload: str, cfg_path,
                        stats: torch.Tensor, nvt: dict) -> dict:
    """A field path through the user's entry point
    (``bench.run_bench_field``, the flags of FIELD): launch counts over
    exactly this run (every sub-step launch the field form), the
    invariants (no particle in the walls, for ka3d the A and B
    populations), the acceptance, the carried dE against the float64
    pair + field total difference, and a frame origin that moved. The
    energy gate counts the field energy the grid shifts themselves change
    (``replay_field_run``, whose final state must equal the run's bit for
    bit), as the CPU tests' anchors count the shifts' jumps; the gap
    without them is printed beside it.
    ``cfg_path`` is the workload's configuration at its defaults (the
    walls sit at its box)."""
    w = FIELD[workload]
    field = path_field(bench, workload, cfg_path)
    reset(libs)
    stats.zero_()
    result, cfg, pot, st, origin, warm, m = bench.run_bench_field(
        workload, field, sweeps=w["sweeps"])
    torch.cuda.synchronize()
    print(json.dumps(result))
    launches = {name: lib.launches for name, lib in libs.items()}
    field_launches = libs[w["lib"]].field_launches
    total_sweeps = 2 * w["sweeps"]
    per_sweep = 1 if workload == "hard-disk" else cfg.n_colors
    expect_launches(libs, launches, w["lib"], per_sweep, total_sweeps,
                    field=True)
    check_result(mt, cfg, pot, st, result)
    species = ENERGETIC.get(workload, {}).get("species")
    result.update(mt.validate_state(cfg, st, pot, expect_species=species))
    if species is not None and [result["n_a"], result["n_b"]] != species:
        raise AssertionError(f"{workload} field: A, B = {result['n_a']}, "
                             f"{result['n_b']}, want {species}")
    if result["field_violations"]:
        raise AssertionError(f"{workload} field: {result['field_violations']}"
                             " particles in the walls")
    e0 = result["pair_energy_start"] + result["field_energy_start"]
    e1 = result["energy_f64"]
    de = result["carried_energy"] - e0
    r_st, r_org, jumps = replay_field_run(mt, bench, workload, cfg, pot,
                                          field, total_sweeps)
    if not (bitwise_equal(r_st.pos, st.pos) and torch.equal(r_st.occ, st.occ)
            and bitwise_equal(r_org, origin)):
        raise AssertionError(f"{workload} field: the replay's state differs "
                             "from the run's")
    gap = abs((e1 - e0) - (de + jumps))
    gap_moves = abs((e1 - e0) - de)
    result.update(shift_field_jumps=jumps, anchor_gap=gap,
                  anchor_rel_gap_moves_only=gap_moves / max(1.0,
                                                            abs(e1 - e0)))
    if gap > ANCHOR_REL * max(1.0, abs(e1 - e0)):
        raise AssertionError(f"{workload} field: E {e0} -> {e1} "
                             f"(difference {e1 - e0}), summed dE {de}, the "
                             f"shifts' field changes {jumps}")
    if not any(abs(o) > 0 for o in result["origin"]):
        raise AssertionError(f"{workload} field: the frame origin never "
                             "moved")
    result.update(launches=launches, anchor_rel_gap=gap / max(1.0, abs(e1 - e0)),
                  summed_de=de, overflow_cells=int(stats[0]),
                  field_launches=field_launches,
                  nvt_ms_per_sweep=nvt["ms_per_sweep"])
    print(json.dumps({k: result[k] for k in (
        "launches", "anchor_rel_gap", "anchor_rel_gap_moves_only",
        "summed_de", "shift_field_jumps", "overflow_cells",
        "field_launches")}))
    return result


# The Philox (in-kernel draw) phases.
PHILOX_COUNTERS = 1 << 22       # counters of the words check (4,194,304)
# Random123's philox4x32-10 known-answer vectors: counter, key, words.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]
PHILOX_SEED = 0x5EED_0000_0000_002A   # both key words nonzero
PHILOX_IH_K = 8                        # mcjax's bench default in 3D
SMALL_PHILOX = dict(n=4096, sweeps=5)
RESUME_SWEEPS = (2, 2)


def check_philox_words(cuda_substep) -> float:
    """Philox words: the kernel (csrc/philox.cuh through
    mcjax_philox_words) against the plain philox4x32 on the card, bit for
    bit, on PHILOX_COUNTERS random counters, and on Random123's three
    known-answer vectors."""
    from mcjax_torch.ops.random import philox4x32
    g = torch.Generator("cuda").manual_seed(11)
    ctr = torch.randint(0, 1 << 32, (4, PHILOX_COUNTERS), generator=g,
                        device="cuda", dtype=torch.int64)
    key = (0x9E3779B9, 0xDEADBEEF)
    got = cuda_substep.philox_words(ctr, key)
    want = philox4x32(ctr, key)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"Philox words: kernel != plain at "
                             f"{int((got != want).any(0).sum())} counters")
    for c, k, words in PHILOX_KAT:
        t = torch.tensor(c, dtype=torch.int64, device="cuda").reshape(4, 1)
        out = tuple(cuda_substep.philox_words(t, k)[:, 0].tolist())
        if out != words:
            raise AssertionError(f"Philox known-answer vector {c}, {k}: "
                                 f"{[hex(v) for v in out]}")
    print(f"Philox words: kernel == plain on {PHILOX_COUNTERS} counters; "
          f"Random123's {len(PHILOX_KAT)} known-answer vectors reproduced")
    return 0.0


def check_philox_disk_kernel(cuda_substep, cfg, pot, st):
    """The 2D Philox form at 1M: one launch of a sweep's four sub-steps
    against its plain version on the same start (``PhiloxRandoms.
    move_draws``, then four plain sub-steps), and against the host-random
    kernel fed the same draws materialized on the card: positions,
    occupancies and counts bit for bit. Returns (largest difference from
    the plain version, the timing input)."""
    from mcjax_torch.ops.random import PhiloxRandoms
    rnd = PhiloxRandoms(PHILOX_SEED, "cuda")
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    key = rnd.kernel_key(st.sweep)
    before = st.pos.clone()
    occ0 = st.occ.clone()
    want = st.pos.clone()
    draws, plain_counts = [], []
    for i in range(cfg.n_colors):
        color = int(perm[i])
        draws.append(rnd.move_draws(cfg, st.sweep, i, color, False))
        own, _, acc, prop = cuda_substep.color_substep(
            cfg, pot, color, want, st.occ, *draws[-1][:2])
        want[color] = own
        plain_counts.append((int(acc), int(prop)))
    twin = st.pos.clone()
    _, t_acc, t_prop = cuda_substep.substeps(cfg, pot, twin, st.occ, perm,
                                             draws)
    work = st.pos.clone()
    _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, work, st.occ, perm,
                                             key)
    torch.cuda.synchronize()
    t_counts = list(zip(t_acc.tolist(), t_prop.tolist()))
    k_counts = list(zip(k_acc.tolist(), k_prop.tolist()))
    if not (bitwise_equal(work, want) and bitwise_equal(st.occ, occ0)
            and k_counts == plain_counts):
        raise AssertionError(f"2D Philox form != its plain version (counts "
                             f"{k_counts} against {plain_counts})")
    if not (bitwise_equal(work, twin) and k_counts == t_counts):
        raise AssertionError("2D Philox form != host-random kernel fed the "
                             "same Philox draws")
    print(f"substep_philox, one launch of 4 sub-steps (colors "
          f"{perm.tolist()}): bitwise equal to its plain version "
          f"(PhiloxRandoms.move_draws and 4 plain sub-steps) and to the "
          f"host-random kernel fed the same draws (pos, occ, counts); "
          f"accepted / proposed {k_counts}")
    return abs_err(work, want), (before, perm, key, draws)


def check_philox_energetic(cuda_substep, workload, cfg, pot, st):
    """An energetic Philox form at 1M, all 8 colors of a sweep in turn:
    each launch against its plain version (``PhiloxRandoms.move_draws``,
    then the plain sub-step) and against the host-random kernel fed the
    same draws materialized on the card, on the same state: bit for bit
    outside cells where the plain version's decision came within NEAR_TIE
    of a tie, the sub-step's dE within DE_REL + DE_ABS of the plain
    version's where no cell differs. The state goes on from the twin's.
    Returns (largest per-cell dE difference from the plain version, the
    timing input: state before the last sub-step, perm, i, its draws, the
    plain version's record, the key)."""
    from mcjax_torch.ops.random import PhiloxRandoms
    w = ENERGETIC[workload]
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    rnd = PhiloxRandoms(PHILOX_SEED + w["seed"], "cuda", PHILOX_IH_K)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    key = rnd.kernel_key(st.sweep)
    ph = cuda_substep.philox_args(cfg, key, True)
    twin, work = st.pos.clone(), st.pos.clone()
    maps = [(torch.empty(cfg.block_shape, dtype=torch.float32, device="cuda"),
             torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda"))
            for _ in range(2)]
    (de_t, acc_t), (de_k, acc_k) = maps
    n_diff = n_twin = n_ties = 0
    worst = 0.0
    timing = None
    for i in range(cfg.n_colors):
        color = int(perm[i])
        draws = rnd.move_draws(cfg, st.sweep, i, color, True)
        before = twin.clone()
        rec = {}
        own, de, acc, _ = plain(cfg, pot, color, before.clone(), st.occ,
                                *draws, rec)
        launch(cfg, pot, twin, st.occ, perm, i, *draws, de_t, acc_t)
        launch(cfg, pot, work, st.occ, perm, i, None, None, None, de_k, acc_k,
               ph=ph)
        torch.cuda.synchronize()
        got = work[color].view(torch.int32)
        vs_plain = (got != own.view(torch.int32)).any(0).any(0)
        vs_twin = (got != twin[color].view(torch.int32)).any(0).any(0)
        ties = rec["margin"] <= NEAR_TIE
        for what, differs in (("its plain version", vs_plain),
                              ("the host-random twin", vs_twin)):
            if bool((differs & ~ties).any()):
                raise AssertionError(
                    f"{workload} Philox form != {what} outside near ties, "
                    f"color {color}: {int((differs & ~ties).sum())} cells")
        k_de = float(de_k.double().sum())
        if not bool(vs_plain.any()) and (
                int(acc_k.sum()) != int(acc)
                or abs(k_de - float(de)) > DE_REL * abs(float(de)) + DE_ABS):
            raise AssertionError(f"{workload} Philox form color {color}: "
                                 f"accepted {int(acc_k.sum())} vs {int(acc)}"
                                 f", dE {k_de} vs plain {float(de)}")
        same = ~vs_plain
        if bool(same.any()):
            worst = max(worst,
                        float((de_k - rec["de_cell"]).abs()[same].max()))
        n_diff += int(vs_plain.sum())
        n_twin += int(vs_twin.sum())
        n_ties += int(ties.sum())
        work[color] = twin[color]
        timing = (before, perm, i, draws, rec, key)
    print(f"{workload} Philox form (ih_k {PHILOX_IH_K}), 8 colors at "
          f"N = {cfg.n_atoms}: {n_diff} cells differ from its plain version "
          f"and {n_twin} from the host-random twin fed the same draws, all "
          f"near ties (near-tie cells {n_ties}); largest per-cell dE "
          f"difference from the plain version {worst:.3e}")
    return worst, timing


def check_philox_small_run_against_cpu(mt, bench) -> None:
    """A small 2D run through the Philox form equals the plain CPU path
    under the same PhiloxRandoms, bit for bit."""
    from mcjax_torch.ops.random import PhiloxRandoms
    n, sweeps = SMALL_PHILOX["n"], SMALL_PHILOX["sweeps"]
    cfg, pot, st = bench.build(n, 0.5, 2.0, 7, 16, device="cuda")
    st_gpu, m_gpu = mt.run_sweeps(cfg, pot, st, sweeps,
                                  PhiloxRandoms(PHILOX_SEED, "cuda"))
    _, _, st_cpu = bench.build(n, 0.5, 2.0, 7, 16, device="cpu")
    st_cpu, m_cpu = mt.run_sweeps(cfg, pot, st_cpu, sweeps,
                                  PhiloxRandoms(PHILOX_SEED, "cpu"))
    for name in ("pos", "occ"):
        if not bitwise_equal(getattr(st_gpu, name).cpu(),
                             getattr(st_cpu, name)):
            raise AssertionError(f"Philox small run: GPU {name} != CPU")
    for name in ("accepted", "proposed", "overflow"):
        if not torch.equal(getattr(m_gpu, name).cpu(), getattr(m_cpu, name)):
            raise AssertionError(f"Philox small run: GPU {name} != CPU")
    print(f"Philox small run (N={n}, {sweeps} sweeps): GPU Philox kernels "
          f"== CPU plain path under the same PhiloxRandoms, accepted "
          f"{m_gpu.accepted.tolist()}")


def check_resume(mt, bench) -> None:
    """A resumed run equals an unbroken one on the card, bit for bit:
    RESUME_SWEEPS sweeps with a new provider at the break against their
    sum in one run, 2D hard disks and lj3d at 1M, under PhiloxRandoms
    (the kernels' Philox forms) and TorchRandoms."""
    from mcjax_torch.ops.random import PhiloxRandoms
    first, second = RESUME_SWEEPS
    for workload in ("hard-disk", "lj3d"):
        ih_k = bench.DEFAULT_IH_K[workload]
        makers = {"in-kernel": lambda: PhiloxRandoms(PHILOX_SEED, "cuda",
                                                      ih_k),
                  "host": lambda: mt.TorchRandoms(
                      torch.Generator("cuda").manual_seed(5))}
        for mode, make in makers.items():
            cfg, pot, a, _ = bench.build_workload(workload, device="cuda")
            _, _, b, _ = bench.build_workload(workload, device="cuda")
            a, ma = mt.run_sweeps(cfg, pot, a, first + second, make())
            b, mb1 = mt.run_sweeps(cfg, pot, b, first, make())
            b, mb2 = mt.run_sweeps(cfg, pot, b, second, make())
            torch.cuda.synchronize()
            same = bitwise_equal(a.pos, b.pos) and bitwise_equal(a.occ, b.occ)
            for f in ("delta_e", "accepted", "proposed", "overflow"):
                same &= bitwise_equal(getattr(ma, f),
                                      torch.cat([getattr(mb1, f),
                                                 getattr(mb2, f)]))
            if not same:
                raise AssertionError(f"{workload} ({mode} draws): "
                                     f"{first} + {second} sweeps != "
                                     f"{first + second}")
            print(f"{workload} ({mode} draws) at N = {cfg.n_atoms}: {first} "
                  f"+ {second} sweeps, a new provider at the break, == "
                  f"{first + second} sweeps bit for bit")


def run_rng_gate() -> dict:
    """The full statistical gate of the in-kernel draws on the card,
    printed check by check; fails unless every check passes."""
    from mcjax_torch.utils.rng_gate import run_gate
    res = run_gate(ih_k=PHILOX_IH_K, device="cuda")
    if not res["ok"]:
        raise AssertionError(f"rng gate failed: {res['failures']}")
    print(f"rng gate: {len(res['checks'])} checks passed (ih_k "
          f"{res['ih_k']}, sizes {res['sizes']})")
    return res


def philox_int_ops(cfg, occ, colors, need_acc: bool, ih_k: int) -> int:
    """INT32 operations of the in-kernel draws for the moves of ``colors``:
    every move of a non-empty cell makes its Philox calls and transforms
    its words (random.move_layout)."""
    from mcjax_torch.ops.random import move_layout
    per, calls = move_layout(cfg, need_acc, ih_k)
    words = 1 + int(need_acc) + cfg.dim * per
    cells_live = sum(int((occ[c] > 0).sum()) for c in colors)
    return cfg.n_moves * cells_live * (calls * OPS_PER_PHILOX_CALL
                                       + words * OPS_PER_PHILOX_WORD)


def time_philox(mt, cuda_substep, cells, cfg, pot, st, inputs, energetic):
    """Each Philox form's time by CUDA events (TIMED_LAUNCHES launches),
    its host-random twin's on the same state and the same (materialized)
    draws, the plain version's (materializing the draws, then the plain
    sub-steps) and the bound. Returns (times, bounds)."""
    from mcjax_torch.ops.random import PhiloxRandoms
    times, bounds = {}, {}
    before, perm, key, draws = inputs
    work = before.clone()
    counts = torch.zeros((cfg.n_colors, 2), dtype=torch.int64, device="cuda")
    ph = cuda_substep.philox_args(cfg, key, False)
    shape = cuda_substep.kernel_shape(cuda_substep.LIB, cfg.nmax,
                                      cfg.cells_per_color, philox=True)
    print(f"substep_philox shape at nmax {cfg.nmax}: {shape['registers']} "
          f"registers, {shape['local_bytes']} bytes local, shared memory "
          f"{shape['static_smem']} static + {shape['dynamic_smem']} dynamic "
          f"bytes a block, {shape['warps_per_sm']} resident warps an SM; "
          f"cooperative grid {shape['grid_blocks']} blocks")
    times["substep_philox"] = cuda_ms(
        lambda: cuda_substep.launch_philox_kernel(
            cfg, pot, work, st.occ, perm, 0, cfg.n_colors, ph, counts),
        TIMED_LAUNCHES)
    work.copy_(before)
    pick_us, disps = [d[0] for d in draws], [d[1] for d in draws]
    times["substep_philox_twin"] = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, 0, pick_us, disps, counts),
        TIMED_LAUNCHES)

    def plain_2d():
        rnd = PhiloxRandoms(key.seed, "cuda", key.ih_k)
        pos = before.clone()
        for j in range(cfg.n_colors):
            c = int(perm[j])
            p_u, dsp, _ = rnd.move_draws(cfg, key.sweep, j, c, False)
            pos[c] = cuda_substep.color_substep(cfg, pot, c, pos, st.occ,
                                                p_u, dsp)[0]
    times["substep_philox_plain"] = cuda_ms(plain_2d, PLAIN_RUNS)
    bounds["substep_philox"] = substep_bound_ms(
        cfg, st, (before, perm, draws), cells, draws_read=False,
        int_ops=philox_int_ops(cfg, st.occ, [int(c) for c in perm], False, 0))
    for workload, (ecfg, epot, est, timing) in energetic.items():
        name = PHILOX_ROWS[workload]
        e_before, e_perm, i, e_draws, rec, e_key = timing
        launch = getattr(cuda_substep, ENERGETIC[workload]["launch"])
        e_ph = cuda_substep.philox_args(ecfg, e_key, True)
        de_map = torch.empty(ecfg.block_shape, dtype=torch.float32,
                             device="cuda")
        acc_map = torch.empty(ecfg.block_shape, dtype=torch.int32,
                              device="cuda")
        shape = cuda_substep.kernel_shape(
            cuda_substep.kernel_library(ecfg, epot), ecfg.nmax, philox=True)
        print(f"{name} shape at nmax {ecfg.nmax}: {shape['registers']} "
              f"registers, {shape['local_bytes']} bytes local, shared "
              f"memory {shape['static_smem']} static + "
              f"{shape['dynamic_smem']} dynamic bytes a block, "
              f"{shape['warps_per_sm']} resident warps an SM, "
              f"{shape['staged_capacity']} staged slots a warp")
        e_work = e_before.clone()
        times[name] = cuda_ms(lambda: launch(
            ecfg, epot, e_work, est.occ, e_perm, i, None, None, None, de_map,
            acc_map, ph=e_ph), TIMED_LAUNCHES)
        e_work.copy_(e_before)
        times[name + "_twin"] = cuda_ms(lambda: launch(
            ecfg, epot, e_work, est.occ, e_perm, i, *e_draws, de_map,
            acc_map), TIMED_LAUNCHES)
        plain = plain_substep(cuda_substep, epot)
        color = int(e_perm[i])
        rnd = PhiloxRandoms(e_key.seed, "cuda", e_key.ih_k)
        times[name + "_plain"] = cuda_ms(lambda: plain(
            ecfg, epot, color, e_before, est.occ,
            *rnd.move_draws(ecfg, e_key.sweep, i, color, True)), PLAIN_RUNS)
        ops = OPS_PER_MIX_TERM if workload == "ka3d" else OPS_PER_LJ_TERM
        bounds[name] = energetic_substep_bound_ms(
            ecfg, est, timing[:5], cells, ops, draws_read=False,
            int_ops=philox_int_ops(ecfg, est.occ, [color], True, e_key.ih_k))
    for name in bounds:
        print(f"{name}: {times[name]:.6f} ms against its host-random twin "
              f"{times[name + '_twin']:.6f} ms on the same state and draws "
              f"({smi_line()})")
    return times, bounds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import mcjax_torch as mt
    from mcjax_torch import _build, bench
    from mcjax_torch.ops import cells, cuda_shift, cuda_substep

    smi = smi_line()
    print(f"card: {smi}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")

    libs = {"substep": cuda_substep.LIB,
            "substep_field": cuda_substep.LIB_FIELD,
            "substep_philox": cuda_substep.LIB_PHILOX,
            "substep_lj": cuda_substep.LIB_LJ,
            "substep_mix": cuda_substep.LIB_MIX, "shift": cuda_shift.LIB}
    build_s = _build.build_all(list(libs.values()))
    each = ", ".join(f"{name} {lib.build_seconds:.1f} s"
                     for name, lib in libs.items()
                     if lib.build_seconds is not None)
    print(f"kernels built in {build_s:.1f} s ({each})")
    for name, lib in libs.items():
        lib.load()
        entry = name
        for line in lib.build_log.splitlines():     # nvcc -Xptxas -v
            if "Compiling entry function" in line:
                targs = re.search(r"I((?:L[ib]\d+E)+)E", line)
                params = re.findall(r"\d+", targs[1]) if targs else []
                entry = f"{name}<{','.join(params)}>" if params else name
            elif "registers" in line or "spill" in line:
                print(f"  {entry}: {line.split(':')[-1].strip()}")

    # 2D hard disks
    cfg, pot, st, err, inputs = check_kernels_against_plain(mt, cuda_substep,
                                                            cuda_shift)
    check_small_run_against_cpu(mt)
    # the 2D NPT form on the state the NVT checks left, and an NPT small run
    err["substep_npt"] = check_npt_disk_kernel(
        mt, cuda_substep, cfg, pot, dataclasses.replace(st, pos=st.pos.clone()))
    check_npt_small_run_against_cpu(mt)
    # the 2D field form likewise, and a walled small run
    err["substep_field"] = check_field_disk_kernel(
        mt, bench, cuda_substep, cfg, pot,
        dataclasses.replace(st, pos=st.pos.clone()))
    check_field_small_run_against_cpu(mt, bench)
    # the in-kernel draws: the words, the 2D Philox form, a small run
    check_philox_words(cuda_substep)
    err["substep_philox"], philox_inputs = check_philox_disk_kernel(
        cuda_substep, cfg, pot, dataclasses.replace(st, pos=st.pos.clone()))
    check_philox_small_run_against_cpu(mt, bench)
    # 3D Lennard-Jones and the Kob-Andersen mixture
    energetic = {}
    philox_energetic = {}
    field_timing = {}
    path_cfgs = {"hard-disk": cfg}
    for workload in ENERGETIC:
        ecfg, epot, est, eerr, einputs = check_energetic_against_plain(
            mt, cuda_substep, cuda_shift, workload)
        err.update(eerr)
        check_energetic_small_run_against_cpu(mt, cuda_substep, cuda_shift,
                                              workload)
        err[ENERGETIC[workload]["substep"] + "_npt"] = check_npt_energetic(
            mt, cuda_substep, workload, ecfg, epot,
            dataclasses.replace(est, pos=est.pos.clone()))
        energetic[workload] = time_energetic(mt, cuda_substep, cuda_shift,
                                             cells, workload, ecfg, epot,
                                             est, einputs)
        err[FIELD[workload]["substep"]] = check_field_energetic_kernel(
            mt, bench, cuda_substep, workload, ecfg, epot,
            dataclasses.replace(est, pos=est.pos.clone()))
        field_timing[workload] = time_field_energetic(
            mt, bench, cuda_substep, cells, workload, ecfg, epot, est,
            einputs)
        err[PHILOX_ROWS[workload]], ptiming = check_philox_energetic(
            cuda_substep, workload, ecfg, epot,
            dataclasses.replace(est, pos=est.pos.clone()))
        philox_energetic[workload] = (ecfg, epot, est, ptiming)
        path_cfgs[workload] = ecfg
        del est, einputs

    # Kernel and plain-version times at the main-path shapes. Kernels
    # alone: the wrappers' checks, allocations and count reductions stay
    # out of the timed loop, and these launches are not counted.
    before, perm, draws = inputs["substep"]
    work = before.clone()
    counts = torch.zeros((len(draws), 2), dtype=torch.int64, device="cuda")
    shape = cuda_substep.kernel_shape(cuda_substep.LIB, cfg.nmax,
                                      cfg.cells_per_color)
    print(f"substep shape at nmax {cfg.nmax}: {shape['registers']} "
          f"registers, {shape['local_bytes']} bytes local, shared memory "
          f"{shape['static_smem']} static + {shape['dynamic_smem']} dynamic "
          f"bytes a block, {shape['warps_per_sm']} resident warps an SM, "
          f"{shape['staged_capacity']} staged frozen slots a thread; "
          f"cooperative grid {shape['grid_blocks']} blocks of 128 threads "
          f"for {cfg.cells_per_color} cells a color")
    pick_us = [p for p, _, _ in draws]
    disps = [dd for _, dd, _ in draws]
    times = {}
    times["substep"] = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, 0, pick_us, disps, counts),
        TIMED_LAUNCHES)

    def plain_sweep_substeps():
        pos = before.clone()
        for j, (p_u, dsp, _) in enumerate(draws):
            c = int(perm[j])
            pos[c] = cuda_substep.color_substep(cfg, pot, c, pos, st.occ,
                                                p_u, dsp)[0]
    times["substep_plain"] = cuda_ms(plain_sweep_substeps, PLAIN_RUNS)
    # the NPT form on the same input
    scale = npt_scale(NPT_TIME_SCALE)
    s2 = cuda_substep.scale_squared(scale, torch.float32, "cuda")
    npt_shape = cuda_substep.kernel_shape(cuda_substep.LIB, cfg.nmax,
                                          cfg.cells_per_color, scaled=True)
    print(f"substep_npt shape at nmax {cfg.nmax}: {npt_shape['registers']} "
          f"registers, {npt_shape['local_bytes']} bytes local, shared memory "
          f"{npt_shape['static_smem']} static + {npt_shape['dynamic_smem']} "
          f"dynamic bytes a block, {npt_shape['warps_per_sm']} resident warps"
          f" an SM; cooperative grid {npt_shape['grid_blocks']} blocks")
    work.copy_(before)
    times["substep_npt"] = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, 0, pick_us, disps, counts, s2),
        TIMED_LAUNCHES)

    def plain_sweep_substeps_npt():
        pos = before.clone()
        for j, (p_u, dsp, _) in enumerate(draws):
            c = int(perm[j])
            pos[c] = cuda_substep.color_substep(cfg, pot, c, pos, st.occ,
                                                p_u, dsp, scale=scale)[0]
    times["substep_npt_plain"] = cuda_ms(plain_sweep_substeps_npt, PLAIN_RUNS)
    s_pos, s_occ, s_axis, s_d = inputs["shift"]
    outs = (torch.empty_like(s_pos), torch.empty_like(s_occ),
            torch.zeros((), dtype=torch.int32, device="cuda"))
    times["shift"] = cuda_ms(lambda: cuda_shift.launch_kernel(
        cfg, s_pos, s_occ, s_axis, s_d, *outs), TIMED_LAUNCHES)
    times["shift_plain"] = cuda_ms(lambda: cuda_shift.shift_rebin(
        cfg, s_pos, s_occ, s_axis, s_d), PLAIN_RUNS)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(3))
    rng_ms = cuda_ms(lambda: rnd.substep(cfg, 0, 0, False), TIMED_LAUNCHES)
    sched_ms = cuda_ms(lambda: rnd.schedule(cfg, 0), TIMED_LAUNCHES)
    field_timing["hard-disk"] = time_field_disk(mt, bench, cuda_substep,
                                                cells, cfg, pot, st, inputs)
    p_times, p_bounds = time_philox(mt, cuda_substep, cells, cfg, pot, st,
                                    philox_inputs, philox_energetic)
    del philox_energetic, philox_inputs

    reset(libs)

    bounds = {
        "substep": substep_bound_ms(cfg, st, inputs["substep"], cells),
        "substep_npt": substep_bound_ms(cfg, st, inputs["substep"], cells,
                                        OPS_PER_PAIR_TEST + 1),
        "shift": shift_bound_ms(cfg, st),
    }
    for e_times, e_bounds, _ in energetic.values():
        times.update(e_times)
        bounds.update(e_bounds)
    for f_times, f_bounds in field_timing.values():
        times.update(f_times)
        bounds.update(f_bounds)
    times.update(p_times)
    bounds.update(p_bounds)

    stats = cuda_substep.kernel_stats("cuda")
    main64 = run_main_path(mt, bench, libs, 64, stats)
    main8 = run_main_path(mt, bench, libs, 8, stats)
    paths = {workload: run_energetic_main_path(
        mt, bench, libs, workload, cuda_substep.kernel_stats("cuda"))
        for workload in ENERGETIC}
    # mcjax's bench defaults: the in-kernel (Philox) draws
    philox64 = run_main_path(mt, bench, libs, 64, stats, rng="in-kernel")
    philox8 = run_main_path(mt, bench, libs, 8, stats, rng="in-kernel")
    philox_paths = {workload: run_energetic_main_path(
        mt, bench, libs, workload, cuda_substep.kernel_stats("cuda"),
        rng="in-kernel") for workload in ENERGETIC}
    check_resume(mt, bench)
    henderson = check_henderson(mt, libs)
    npt_paths = {workload: run_npt_main_path(
        mt, bench, libs, workload, cuda_substep.kernel_stats("cuda"),
        paths[workload]) for workload in NPT}
    field_paths = {workload: run_field_main_path(
        mt, bench, libs, workload, path_cfgs[workload],
        cuda_substep.kernel_stats("cuda"),
        main64 if workload == "hard-disk" else paths[workload])
        for workload in FIELD}
    for res in (main64, main8):
        print(f"hard disks, n_moves {res['n_moves']}: {res['value']:.6e} "
              f"moves/s, {res['ms_per_sweep']:.6f} ms/sweep ({smi}); "
              f"{res['overflow_cells']} of {res['cell_substeps']} cell "
              "sub-steps took the overflow pass")
    for host, res in ((main64, philox64), (main8, philox8)):
        print(f"hard disks, n_moves {res['n_moves']}, in-kernel draws: "
              f"{res['value']:.6e} moves/s, {res['ms_per_sweep']:.6f} "
              f"ms/sweep against {host['ms_per_sweep']:.6f} ms/sweep with "
              f"host draws ({smi}); {res['overflow_cells']} overflow-pass "
              "cell sub-steps")
    for workload, res in philox_paths.items():
        print(f"{workload}, n_moves {res['n_moves']}, in-kernel draws (ih_k "
              f"{res['ih_k']}): {res['value']:.6e} moves/s, "
              f"{res['ms_per_sweep']:.6f} ms/sweep against "
              f"{paths[workload]['ms_per_sweep']:.6f} ms/sweep with host "
              f"draws; acceptance {res['acceptance']:.6f} (host "
              f"{paths[workload]['acceptance']:.6f}); energy anchor gap "
              f"{res['anchor_rel_gap']:.3e} ({smi})")
    for workload, res in paths.items():
        print(f"{workload}, n_moves {res['n_moves']}: {res['value']:.6e} "
              f"moves/s, {res['ms_per_sweep']:.6f} ms/sweep, acceptance "
              f"{res['acceptance']:.6f}, energy anchor gap "
              f"{res['anchor_rel_gap']:.3e} ({smi})")
        print(f"{workload} main path: {res['overflow_cells']} of "
              f"{res['cell_launches']} cell sub-steps took the overflow "
              f"pass; {res['full_terms_per_substep']:.1f} full pair terms "
              "per sub-step")
    print(f"per sweep at n_moves 64 ({smi}): substep kernel 1 x "
          f"{times['substep']:.6f} ms (4 sub-steps), random draws 4 x "
          f"{rng_ms:.6f} ms, "
          f"schedule draw {sched_ms:.6f} ms, shift kernel "
          f"{times['shift']:.6f} ms")
    for workload, (_, _, e_rng_ms) in energetic.items():
        w = ENERGETIC[workload]
        print(f"per {workload} sweep ({smi}): substep kernel 8 x "
              f"{times[w['substep']]:.6f} ms, random draws 8 x "
              f"{e_rng_ms:.6f} ms, 3D shift kernel {times[w['shift']]:.6f} "
              "ms")
    for workload, res in npt_paths.items():
        print(f"{workload} NPT (P {res['pressure']}, dlnv_max "
              f"{res['dlnv_max']}), n_moves {res['n_moves']}: "
              f"{res['value']:.6e} moves/s, {res['ms_per_sweep']:.6f} ms per "
              f"NPT sweep against {res['nvt_ms_per_sweep']:.6f} ms per NVT "
              f"sweep; volume move {res['volume_move_ms']:.6f} ms "
              f"({res['volume_move_share']:.4f} of an NPT sweep), peak "
              f"{res['volume_move_peak_bytes'] / 2**30:.3f} GiB above the "
              f"state; volume acceptance {res['volume_acceptance']:.4f} "
              f"({res['volume_accepted']} of {res['volume_moves']}); final "
              f"scale {res['scale_final']:.7f}, density "
              f"{res['density_final']:.6f}; carried energy gap "
              f"{res['carried_energy_rel_err']:.3e} ({smi})")
        print(f"{workload} NPT volume moves of the warm-up: float32 dU - "
              f"float64 dU at most {res['du_f32_minus_f64_max']:.6f} (mean "
              f"{res['du_f32_minus_f64_mean']:.6f}; beta x max "
              f"{res['beta_du_gap_max']:.6f}; mean |dU| "
              f"{res['du_f64_abs_mean']:.3f}); of it the carried energy "
              f"against a fresh float32 total at most "
              f"{res['carried_minus_fresh_f32_max']:.6f}, two fresh float32 "
              f"totals' dU against float64 at most "
              f"{res['du_fresh_f32_minus_f64_max']:.6f}; one-ring refusals "
              f"{res['one_ring_refusals']}; {res['overflow_cells']} of "
              f"{res['cell_launches']} cell sub-steps took the overflow pass")
    for workload, res in field_paths.items():
        print(f"{workload} field ({res['metric']}), n_moves "
              f"{res['n_moves']}: {res['value']:.6e} moves/s, "
              f"{res['ms_per_sweep']:.6f} ms per field sweep against "
              f"{res['nvt_ms_per_sweep']:.6f} ms per NVT sweep; acceptance "
              f"{res['acceptance']:.6f}; slab density "
              f"{res['slab_density']:.6f}; pair energy {res['pair_energy']:.3f}"
              f", field energy {res['field_energy']:.3f} (start "
              f"{res['pair_energy_start']:.3f}, "
              f"{res['field_energy_start']:.3f}); carried dE gap "
              f"{res['anchor_rel_gap']:.3e} with the shifts' field changes "
              f"({res['shift_field_jumps']:.6f}), "
              f"{res['anchor_rel_gap_moves_only']:.3e} without; origin "
              f"{res['origin']}; "
              f"{res['overflow_cells']} overflow-pass cells ({smi})")
    for workload, fw in FIELD.items():
        sub = fw["substep"]
        print(f"{sub}: {times[sub]:.6f} ms against its NVT form "
              f"{times[sub + '_nvt']:.6f} ms on the same input ({smi})")
    for name, (b, by) in bounds.items():
        print(f"{name}: kernel {times[name]:.6f} ms, bound {b:.6f} ms ({by}),"
              f" plain {times[name + '_plain']:.3f} ms")

    sources = {"substep": "substep.cu", "substep_lj3d": "substep_lj.cu",
               "substep_ka3d": "substep_mix.cu", "shift": "shift.cu",
               "shift3d": "shift.cu", "shift_ka3d": "shift.cu",
               "substep_npt": "substep.cu",
               "substep_lj3d_npt": "substep_lj.cu",
               "substep_ka3d_npt": "substep_mix.cu",
               "substep_field": "substep_field.cu",
               "substep_lj3d_field": "substep_lj.cu",
               "substep_ka3d_field": "substep_mix.cu",
               "substep_philox": "substep_philox.cu",
               "substep_lj_philox": "substep_lj.cu",
               "substep_mix_philox": "substep_mix.cu"}
    replaces = {
        "substep": "mcjax/ops/pallas_ring.py:919, mcjax/ops/pallas_ring.py:495",
        "substep_lj3d": "mcjax/ops/pallas_sweep.py:1348, "
                        "mcjax/ops/pallas_sweep.py:878, "
                        "mcjax/ops/pallas_ring.py:495",
        "substep_ka3d": "mcjax/ops/pallas_sweep.py:1348, "
                        "mcjax/ops/pallas_sweep.py:878",
        "shift": "mcjax/ops/pallas_ring.py:1246, mcjax/ops/pallas_shift.py:194",
        "shift3d": "mcjax/ops/pallas_shift.py:194",
        "shift_ka3d": "mcjax/ops/pallas_ring.py:1246",
        "substep_npt": "mcjax/ops/pallas_ring.py:919, "
                       "mcjax/ops/pallas_ring.py:495",
        "substep_lj3d_npt": "mcjax/ops/pallas_sweep.py:1348, "
                            "mcjax/ops/pallas_sweep.py:878, "
                            "mcjax/ops/pallas_ring.py:495",
        "substep_ka3d_npt": "mcjax/ops/pallas_sweep.py:1348, "
                            "mcjax/ops/pallas_sweep.py:878",
        "substep_field": "mcjax/ops/pallas_sweep.py:878",
        "substep_lj3d_field": "mcjax/ops/pallas_sweep.py:1348, "
                              "mcjax/ops/pallas_sweep.py:878",
        "substep_ka3d_field": "mcjax/ops/pallas_sweep.py:1348, "
                              "mcjax/ops/pallas_sweep.py:878",
        "substep_philox": "mcjax/ops/pallas_ring.py:919, "
                          "mcjax/ops/pallas_ring.py:495",
        "substep_lj_philox": "mcjax/ops/pallas_sweep.py:1348, "
                             "mcjax/ops/pallas_sweep.py:878, "
                             "mcjax/ops/pallas_ring.py:495",
        "substep_mix_philox": "mcjax/ops/pallas_sweep.py:1348, "
                              "mcjax/ops/pallas_sweep.py:878",
    }
    launches = {"substep": main64["launches"]["substep"],
                "shift": main64["launches"]["shift"]}
    for workload, res in paths.items():
        w = ENERGETIC[workload]
        launches[w["substep"]] = res["launches"][w["lib"]]
        launches[w["shift"]] = res["launches"]["shift"]
    # NPT forms: the lj3d and ka3d NPT main paths; the 2D form, whose main
    # path (1M disks) is NVT, the hard-disk NPT run
    launches["substep_npt"] = henderson["launches"]
    for workload, res in npt_paths.items():
        w = ENERGETIC[workload]
        launches[w["substep"] + "_npt"] = res["launches"][w["lib"]]
    for workload, res in field_paths.items():
        launches[FIELD[workload]["substep"]] = res["field_launches"]
    launches["substep_philox"] = philox64["launches"]["substep_philox"]
    for workload, res in philox_paths.items():
        launches[PHILOX_ROWS[workload]] = \
            res["launches"][ENERGETIC[workload]["lib"]]
    run_rng_gate()
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"mcjax_torch/csrc/{sources[name]}",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name],
         "plain_ms": times[name + "_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in sources]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
