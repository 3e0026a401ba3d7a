#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``mcjax_torch/csrc`` with nvcc (one nvcc per source, all started together)
and checks two paths, each through the user's entry point
(``mcjax_torch.bench``):

* 2D hard disks (N = 1,048,576, phi 0.5, nmax 7, n_moves 64 and 8): each
  kernel held bit for bit against its plain PyTorch version at full size, a
  small run through the kernels against the plain CPU path fed the same
  random numbers, then the main path with launch counts, overflow, particle
  count, overlaps and acceptance checked.
* 3D Lennard-Jones (N = 1,000,000, rho 0.8, nmax 24, n_moves 60): the LJ
  sub-step kernel against its plain version for all 8 colors at full size
  after a few sweeps (bit for bit outside cells where a decision came
  within a relative NEAR_TIE of a tie, whose count is printed; dE within
  DE_REL + DE_ABS), the 3D shift kernel bit for bit for 3 axes x 2 signs, a
  small run through the kernels against the plain CPU path, then the main
  path (30 + 30 sweeps) with launch counts, overflow, N, ``validate_state``
  and the energy anchor (summed dE against the float64 total-energy
  difference, within ANCHOR_REL).
* the Kob-Andersen 80:20 mixture, ka3d (N = 1,000,000, rho 1.2, nmax 34,
  n_moves 60): the mixture sub-step kernel against its plain version for
  all 8 colors at full size under the same near-tie rule, the shift kernel
  carrying the species plane (4 planes) bit for bit for 3 axes x 2 signs, a
  small run (4,500 atoms) through the kernels against the plain CPU path,
  then the main path (100 + 100 sweeps) with launch counts, overflow, N,
  the A and B populations (800,000 / 200,000), ``validate_state`` and the
  energy anchor.

Any failure raises and the script exits non-zero. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result. The second-to-last lines are a JSON object of per-kernel numbers
and the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

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


class Replay:
    """Provider that hands back a Recorder's tensors, on the CPU."""

    def __init__(self, log):
        self.log = [tuple(None if t is None else t.cpu() for t in item)
                    for item in log]

    def schedule(self, cfg, sweep):
        return self.log.pop(0)

    def substep(self, cfg, sweep, i, need_acc):
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
    """2D: each kernel vs its plain version, at 1M, same inputs."""
    from mcjax_torch import bench
    cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, 64, seed=0,
                               device="cuda")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(1))
    st, _ = mt.run_sweeps(cfg, pot, st, 1, rnd)        # leave the lattice
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    err = {}
    inputs = {}
    sub_err = 0.0
    for i in range(cfg.n_colors):
        pick_u, disp, _ = rnd.substep(cfg, st.sweep, i, False)
        color = int(perm[i])
        before = st.pos.clone()
        own, _, acc, prop = cuda_substep.color_substep(cfg, pot, color,
                                                       st.pos, st.occ, pick_u,
                                                       disp)
        _, k_acc, k_prop = cuda_substep.substep(cfg, pot, st.pos, st.occ,
                                                perm, i, pick_u, disp)
        torch.cuda.synchronize()
        want = before
        want[color] = own
        sub_err = max(sub_err, abs_err(st.pos, want))
        if not bitwise_equal(st.pos, want):
            raise AssertionError(f"substep kernel != plain, color {color}")
        if (int(k_acc), int(k_prop)) != (int(acc), int(prop)):
            raise AssertionError(f"substep counts {int(k_acc)}/{int(k_prop)}"
                                 f" != plain {int(acc)}/{int(prop)}")
        print(f"substep color {color}: bitwise equal, accepted {int(acc)} "
              f"of {int(prop)}")
        inputs["substep"] = (before, perm, i, pick_u, disp)
    err["substep"] = sub_err
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


def substep_bound_ms(cfg, st, inputs, cells) -> tuple[float, str]:
    """2D: least time for one sub-step on this run's data: live slots read
    and written once, random inputs read once; pair tests the occupancies
    need."""
    _, perm, i, pick_u, disp = inputs
    color = int(perm[i])
    occ = st.occ
    live = int(occ.sum())
    own_live = int(occ[color].sum())
    nbytes = (4 * cfg.dim * live + occ.numel() * 4 + 4 * pick_u.numel()
              + 4 * disp.numel() + 4 * cfg.dim * own_live
              + 4 * cfg.cells_per_color)
    _, nbr_occ = cells.neighbor_stack(cfg, st.pos, occ, color)
    own = occ[color].long()
    tests = torch.where(own > 0, (own - 1) + nbr_occ.long().sum(0), 0)
    ops = OPS_PER_PAIR_TEST * cfg.n_moves * int(tests.sum())
    return bound(nbytes, ops)


def energetic_substep_bound_ms(cfg, st, inputs, cells, ops_per_term
                                ) -> tuple[float, str]:
    """3D energetic sub-step: least time for one sub-step on this run's
    data. Bytes: live slots (every plane) and occupancies read once, the
    random inputs read once, the own live slots' coordinates and the two
    per-cell maps written once. Operations: the pair terms the
    frozen-cache algorithm needs, per cell occ x (frozen live slots) for the
    cache, and for each move that stays in its cell the frozen live slots
    plus 2 (occ - 1) own terms."""
    _, perm, i, draws, rec = inputs
    color = int(perm[i])
    occ = st.occ
    nbytes = (4 * st.pos.shape[1] * int(occ.sum()) + 4 * occ.numel()
              + sum(4 * t.numel() for t in draws)
              + 4 * cfg.dim * int(occ[color].sum()) + 8 * cfg.cells_per_color)
    _, nbr_occ = cells.neighbor_stack(cfg, st.pos, occ, color)
    froz = nbr_occ.long().sum(0)
    own = occ[color].long()
    moves = rec["in_cell"].long()
    terms = own * froz + moves * (froz + 2 * (own - 1).clamp(min=0))
    return bound(nbytes, ops_per_term * int(terms.sum()))


def shift_bound_ms(cfg, st) -> tuple[float, str]:
    """Live slots (every plane) read once, the whole output slab and
    occupancy written."""
    nbytes = (4 * st.pos.shape[1] * int(st.occ.sum()) + 4 * st.occ.numel()
              + 4 * st.pos.numel() + 4 * st.occ.numel())
    return bound(nbytes, 0)


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def reset(libs) -> None:
    for lib in libs.values():
        lib.launches = 0


def expect_launches(libs, launches, substep_lib, cfg, total_sweeps) -> None:
    """The run launched its sub-step kernel once per color and sweep, the
    shift once per sweep, and no other kernel."""
    want = {name: 0 for name in libs}
    want[substep_lib] = cfg.n_colors * total_sweeps
    want["shift"] = total_sweeps
    if launches != want:
        raise AssertionError(f"launch counts {launches} for {total_sweeps} "
                             f"sweeps, want {want}")


def run_main_path(mt, bench, libs, n_moves: int) -> dict:
    """2D main path through the user's entry point, with every kernel's
    launch count taken over exactly this run."""
    reset(libs)
    result, cfg, pot, st, _, m = bench.run_bench(n_moves=n_moves,
                                                 sweeps=MAIN_SWEEPS)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    total_sweeps = 2 * MAIN_SWEEPS                   # warm-up + timed
    expect_launches(libs, launches, "substep", cfg, total_sweeps)
    check_result(mt, cfg, pot, st, result)
    result.update(mt.validate_state(cfg, st, pot))   # incl. no overlap
    result["launches"] = launches
    result["ms_per_sweep"] = 1e3 * result["seconds"] / MAIN_SWEEPS
    print(json.dumps(result))
    return result


def run_energetic_main_path(mt, bench, libs, workload: str) -> dict:
    """An energetic main path (lj3d, ka3d) through the user's entry point:
    launch counts over exactly this run, then the invariants (for ka3d the
    A and B populations too) and the energy anchor."""
    w = ENERGETIC[workload]
    cfg0, pot0, start = getattr(bench, w["build"])(1_000_000, w["nmax"], 60,
                                                   seed=0, device="cuda")
    e0 = float(mt.total_energy_cells(cfg0, pot0, start.pos, start.occ,
                                     torch.float64))
    del start
    reset(libs)
    result, cfg, pot, st, warm, m = getattr(bench, w["run"])(
        sweeps=w["sweeps"])
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    total_sweeps = 2 * w["sweeps"]
    expect_launches(libs, launches, w["lib"], cfg, total_sweeps)
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
    result.update(launches=launches, energy_start=e0, energy_end=e1, summed_de=de,
                  anchor_rel_gap=gap / max(1.0, abs(e1 - e0)))
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
    on this run's data, and the time of one sub-step's random draws."""
    w = ENERGETIC[workload]
    sub, sh = w["substep"], w["shift"]
    before, perm, i, draws, _ = inputs["substep"]
    work = before.clone()
    de_map = torch.empty(cfg.block_shape, dtype=torch.float32, device="cuda")
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    launch = getattr(cuda_substep, w["launch"])
    plain = plain_substep(cuda_substep, pot)
    color = int(perm[i])
    times = {
        sub: cuda_ms(lambda: launch(cfg, pot, work, st.occ, perm, i, *draws,
                                    de_map, acc_map), TIMED_LAUNCHES),
        sub + "_plain": cuda_ms(lambda: plain(cfg, pot, color, before,
                                              st.occ, *draws), PLAIN_RUNS),
    }
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
              sh: shift_bound_ms(cfg, st)}
    return times, bounds, rng_ms


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

    libs = {"substep": cuda_substep.LIB, "substep_lj": cuda_substep.LIB_LJ,
            "substep_mix": cuda_substep.LIB_MIX, "shift": cuda_shift.LIB}
    build_s = _build.build_all(list(libs.values()))
    print(f"kernels built in {build_s:.1f} s")
    for name, lib in libs.items():
        lib.load()
        entry = name
        for line in lib.build_log.splitlines():     # nvcc -Xptxas -v
            if "Compiling entry function" in line:
                targs = re.search(r"I((?:Li\d+E)+)E", line)
                params = re.findall(r"\d+", targs[1]) if targs else []
                entry = f"{name}<{','.join(params)}>" if params else name
            elif "registers" in line or "spill" in line:
                print(f"  {entry}: {line.split(':')[-1].strip()}")

    # 2D hard disks
    cfg, pot, st, err, inputs = check_kernels_against_plain(mt, cuda_substep,
                                                            cuda_shift)
    check_small_run_against_cpu(mt)
    # 3D Lennard-Jones and the Kob-Andersen mixture
    energetic = {}
    for workload in ENERGETIC:
        ecfg, epot, est, eerr, einputs = check_energetic_against_plain(
            mt, cuda_substep, cuda_shift, workload)
        err.update(eerr)
        check_energetic_small_run_against_cpu(mt, cuda_substep, cuda_shift,
                                              workload)
        energetic[workload] = time_energetic(mt, cuda_substep, cuda_shift,
                                             cells, workload, ecfg, epot,
                                             est, einputs)
        del est, einputs

    # Kernel and plain-version times at the main-path shapes. Kernels
    # alone: the wrappers' checks, allocations and count reductions stay
    # out of the timed loop, and these launches are not counted.
    before, perm, i, pick_u, disp = inputs["substep"]
    work = before.clone()
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    times = {}
    times["substep"] = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, i, pick_u, disp, acc_map),
        TIMED_LAUNCHES)
    color = int(perm[i])
    times["substep_plain"] = cuda_ms(lambda: cuda_substep.color_substep(
        cfg, pot, color, before, st.occ, pick_u, disp), PLAIN_RUNS)
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

    for lib in libs.values():
        lib.launches = 0

    bounds = {
        "substep": substep_bound_ms(cfg, st, inputs["substep"], cells),
        "shift": shift_bound_ms(cfg, st),
    }
    for e_times, e_bounds, _ in energetic.values():
        times.update(e_times)
        bounds.update(e_bounds)

    main64 = run_main_path(mt, bench, libs, 64)
    main8 = run_main_path(mt, bench, libs, 8)
    paths = {workload: run_energetic_main_path(mt, bench, libs, workload)
             for workload in ENERGETIC}
    for res in (main64, main8):
        print(f"hard disks, n_moves {res['n_moves']}: {res['value']:.6e} "
              f"moves/s, {res['ms_per_sweep']:.6f} ms/sweep ({smi})")
    for workload, res in paths.items():
        print(f"{workload}, n_moves {res['n_moves']}: {res['value']:.6e} "
              f"moves/s, {res['ms_per_sweep']:.6f} ms/sweep, acceptance "
              f"{res['acceptance']:.6f}, energy anchor gap "
              f"{res['anchor_rel_gap']:.3e} ({smi})")
    print(f"per sweep at n_moves 64 ({smi}): substep kernel 4 x "
          f"{times['substep']:.6f} ms, random draws 4 x {rng_ms:.6f} ms, "
          f"schedule draw {sched_ms:.6f} ms, shift kernel "
          f"{times['shift']:.6f} ms")
    for workload, (_, _, e_rng_ms) in energetic.items():
        w = ENERGETIC[workload]
        print(f"per {workload} sweep ({smi}): substep kernel 8 x "
              f"{times[w['substep']]:.6f} ms, random draws 8 x "
              f"{e_rng_ms:.6f} ms, 3D shift kernel {times[w['shift']]:.6f} "
              "ms")
    for name, (b, by) in bounds.items():
        print(f"{name}: kernel {times[name]:.6f} ms, bound {b:.6f} ms ({by}),"
              f" plain {times[name + '_plain']:.3f} ms")

    sources = {"substep": "substep.cu", "substep_lj3d": "substep_lj.cu",
               "substep_ka3d": "substep_mix.cu", "shift": "shift.cu",
               "shift3d": "shift.cu", "shift_ka3d": "shift.cu"}
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
    }
    launches = {"substep": main64["launches"]["substep"],
                "shift": main64["launches"]["shift"]}
    for workload, res in paths.items():
        w = ENERGETIC[workload]
        launches[w["substep"]] = res["launches"][w["lib"]]
        launches[w["shift"]] = res["launches"]["shift"]
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
