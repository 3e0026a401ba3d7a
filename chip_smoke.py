#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``mcjax_torch/csrc`` with nvcc, holds each kernel bit for bit against its
plain PyTorch version on the card at the headline size (N = 1,048,576 hard
disks, phi 0.5, nmax 7, n_moves 64), replays a small run through the kernels
and through the plain CPU path with the same random numbers, then drives the
main path (``mcjax_torch.bench.run_bench``) at n_moves 64 and 8 and checks
launch counts, overflow, particle count, overlaps and acceptance. Any failure
raises and the script exits non-zero. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's name and power limit; the last line is
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
# Operations of one pair test: 2 subtracts, 1 multiply, 1 fma (2), 1 compare.
OPS_PER_PAIR_TEST = 6

MAIN_SWEEPS = 20      # warm-up and timed run of the main path, each
TIMED_LAUNCHES = 20   # kernel launches per timing loop
PLAIN_RUNS = 2        # plain-version calls per timing loop


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


def check_kernels_against_plain(mt, cuda_substep, cuda_shift):
    """Phase 3: each kernel vs its plain version, at 1M, same inputs."""
    from mcjax_torch import bench
    cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, 64, seed=0,
                               device="cuda")
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(1))
    st, _ = mt.run_sweeps(cfg, pot, st, 1, rnd)        # leave the lattice
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    err = {"substep": 0.0, "shift": 0.0}
    inputs = {}
    for i in range(cfg.n_colors):
        pick_u, disp, _ = rnd.substep(cfg, st.sweep, i, False)
        color = int(perm[i])
        before = st.pos.clone()
        own, acc, prop = cuda_substep.color_substep(cfg, pot, color, st.pos,
                                                    st.occ, pick_u, disp)
        k_acc, k_prop = cuda_substep.substep(cfg, pot, st.pos, st.occ, perm,
                                             i, pick_u, disp)
        torch.cuda.synchronize()
        want = before
        want[color] = own
        err["substep"] = max(err["substep"], abs_err(st.pos, want))
        if not bitwise_equal(st.pos, want):
            raise AssertionError(f"substep kernel != plain, color {color}")
        if (int(k_acc), int(k_prop)) != (int(acc), int(prop)):
            raise AssertionError(f"substep counts {int(k_acc)}/{int(k_prop)}"
                                 f" != plain {int(acc)}/{int(prop)}")
        print(f"substep color {color}: bitwise equal, accepted {int(acc)} "
              f"of {int(prop)}")
        inputs["substep"] = (before, perm, i, pick_u, disp)
    for ax in range(cfg.dim):
        for sign in (1, -1):
            a = torch.tensor(ax, dtype=torch.int32, device="cuda")
            dd = (sign * d.abs()).contiguous()
            p_pos, p_occ, p_ovf = cuda_shift.shift_rebin(cfg, st.pos, st.occ,
                                                         a, dd)
            k_pos, k_occ, k_ovf = cuda_shift.shift(cfg, st.pos, st.occ, a, dd)
            torch.cuda.synchronize()
            err["shift"] = max(err["shift"], abs_err(k_pos, p_pos),
                               abs_err(k_occ, p_occ))
            if not (bitwise_equal(k_pos, p_pos) and bitwise_equal(k_occ, p_occ)
                    and bool(k_ovf) == bool(p_ovf)):
                raise AssertionError(f"shift kernel != plain, axis {ax}, "
                                     f"d {float(dd)}")
            print(f"shift axis {ax} d {float(dd):+.6f}: bitwise equal, "
                  f"overflow {bool(k_ovf)}")
    inputs["shift"] = (st.pos, st.occ, axis, d)
    return cfg, pot, st, err, inputs


def check_small_run_against_cpu(mt):
    """A small run through the kernels equals the plain CPU path fed the
    same random numbers."""
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


def substep_bound_ms(cfg, st, inputs, cells) -> tuple[float, str]:
    """Least time for one sub-step on this run's data: live slots read and
    written once, random inputs read once; pair tests the occupancies need."""
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def shift_bound_ms(cfg, st) -> tuple[float, str]:
    """Live slots read once, the whole output slab and occupancy written."""
    nbytes = (4 * cfg.dim * int(st.occ.sum()) + 4 * st.occ.numel()
              + 4 * st.pos.numel() + 4 * st.occ.numel())
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"


def run_main_path(mt, bench, libs, n_moves: int) -> dict:
    """Phase 4: the main path through the user's entry point, with every
    kernel's launch count taken over exactly this run."""
    for lib in libs.values():
        lib.launches = 0
    result, cfg, pot, st, m = bench.run_bench(n_moves=n_moves,
                                              sweeps=MAIN_SWEEPS)
    torch.cuda.synchronize()
    launches = {name: lib.launches for name, lib in libs.items()}
    total_sweeps = 2 * MAIN_SWEEPS                   # warm-up + timed
    if launches != {"substep": cfg.n_colors * total_sweeps,
                    "shift": total_sweeps}:
        raise AssertionError(f"launch counts {launches} for {total_sweeps} "
                             "sweeps")
    if result["overflow"]:
        raise AssertionError("capacity overflow on the main path")
    if int(st.occ.sum()) != cfg.n_atoms:
        raise AssertionError(f"{int(st.occ.sum())} particles, want "
                             f"{cfg.n_atoms}")
    if not 0.0 < result["acceptance"] < 1.0:
        raise AssertionError(f"acceptance {result['acceptance']}")
    if not bool(torch.isfinite(st.pos).all()):
        raise AssertionError("non-finite positions")
    result.update(mt.validate_state(cfg, st, pot))   # incl. no overlap
    result["launches"] = launches
    result["ms_per_sweep"] = 1e3 * result["seconds"] / MAIN_SWEEPS
    print(json.dumps(result))
    return result


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

    libs = {"substep": cuda_substep.LIB, "shift": cuda_shift.LIB}
    build_s = _build.build_all(list(libs.values()))
    print(f"kernels built in {build_s:.1f} s")
    for name, lib in libs.items():
        lib.load()
        entry = name
        for line in lib.build_log.splitlines():     # nvcc -Xptxas -v
            if "Compiling entry function" in line:
                nmax = re.search(r"ILi(\d+)E", line)
                entry = f"{name}<{nmax.group(1)}>" if nmax else name
            elif "registers" in line or "spill" in line:
                print(f"  {entry}: {line.split(':')[-1].strip()}")

    cfg, pot, st, err, inputs = check_kernels_against_plain(mt, cuda_substep,
                                                            cuda_shift)
    check_small_run_against_cpu(mt)

    # Kernel and plain-version times at the main-path shapes.
    # Kernels alone: the wrappers' checks, allocations and count
    # reductions stay out of the timed loop.
    before, perm, i, pick_u, disp = inputs["substep"]
    work = before.clone()
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32, device="cuda")
    sub_ms = cuda_ms(lambda: cuda_substep.launch_kernel(
        cfg, pot, work, st.occ, perm, i, pick_u, disp, acc_map),
        TIMED_LAUNCHES)
    color = int(perm[i])
    sub_plain_ms = cuda_ms(lambda: cuda_substep.color_substep(
        cfg, pot, color, before, st.occ, pick_u, disp), PLAIN_RUNS)
    s_pos, s_occ, s_axis, s_d = inputs["shift"]
    outs = (torch.empty_like(s_pos), torch.empty_like(s_occ),
            torch.zeros((), dtype=torch.int32, device="cuda"))
    shift_ms = cuda_ms(lambda: cuda_shift.launch_kernel(
        cfg, s_pos, s_occ, s_axis, s_d, *outs), TIMED_LAUNCHES)
    shift_plain_ms = cuda_ms(lambda: cuda_shift.shift_rebin(
        cfg, s_pos, s_occ, s_axis, s_d), PLAIN_RUNS)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(3))
    rng_ms = cuda_ms(lambda: rnd.substep(cfg, 0, 0, False), TIMED_LAUNCHES)
    sched_ms = cuda_ms(lambda: rnd.schedule(cfg, 0), TIMED_LAUNCHES)
    sub_bound, sub_by = substep_bound_ms(cfg, st, inputs["substep"], cells)
    shift_bound, shift_by = shift_bound_ms(cfg, st)

    main64 = run_main_path(mt, bench, libs, 64)
    main8 = run_main_path(mt, bench, libs, 8)
    for res in (main64, main8):
        print(f"n_moves {res['n_moves']}: {res['value']:.6e} moves/s, "
              f"{res['ms_per_sweep']:.6f} ms/sweep ({smi})")
    print(f"per sweep at n_moves 64 ({smi}): substep kernel 4 x {sub_ms:.6f} "
          f"ms, random draws 4 x {rng_ms:.6f} ms, schedule draw "
          f"{sched_ms:.6f} ms, shift kernel {shift_ms:.6f} ms; bounds: "
          f"substep {sub_bound:.6f} ms ({sub_by}), shift {shift_bound:.6f} ms "
          f"({shift_by}); plain: substep {sub_plain_ms:.3f} ms, shift "
          f"{shift_plain_ms:.3f} ms")

    kernels = [
        {"name": "substep", "route": "cuda",
         "source": "mcjax_torch/csrc/substep.cu",
         "replaces": "mcjax/ops/pallas_ring.py:919",
         "launches": main64["launches"]["substep"],
         "max_abs_err": err["substep"], "ms": sub_ms,
         "plain_ms": sub_plain_ms, "bound_ms": sub_bound, "bound_by": sub_by,
         "library_ms": None},
        {"name": "shift", "route": "cuda",
         "source": "mcjax_torch/csrc/shift.cu",
         "replaces": "mcjax/ops/pallas_ring.py:1246",
         "launches": main64["launches"]["shift"],
         "max_abs_err": err["shift"], "ms": shift_ms,
         "plain_ms": shift_plain_ms, "bound_ms": shift_bound,
         "bound_by": shift_by, "library_ms": None},
    ]
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
