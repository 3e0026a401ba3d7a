"""Benchmark of the port: MC trial moves/s on one GPU.

Counterpart of the repository's ``bench.py`` for three of its workloads,
run through the port's CUDA kernels, with the same JSON keys:

* ``--workload hard-disk`` (the default, bench.py's headline): 2D hard disks
  of diameter 1 at area fraction phi, cells about wfac diameters wide, so
  4 x 320 x 320 cells at the defaults; uniform proposals of step 0.18,
  n_moves 64, nmax 7, 100 sweeps.
* ``--workload lj3d`` (``bench.py --workload lj3d``, ``bench_lj3d``): 3D
  Lennard-Jones (r_cut 2.5, unshifted) at rho 0.8, beta 0.3, N = 1,000,000
  (L = 107.72, 42^3 cells of width 2.5648 in 8 colors of 21^3), stratified
  start, gaussian proposals of step 0.12, n_moves 60, nmax 24, 30 sweeps.
* ``--workload ka3d`` (``bench.py --workload ka3d``, ``bench_ka3d``): the
  Kob-Andersen 80:20 binary LJ mixture (shifted, r_cut 2.5 sigma per pair)
  at rho 1.2, T 0.8 (beta 1.25), N = 1,000,000 (L = 94.104, 36^3 cells of
  width 2.6140 in 8 colors of 18^3), species B where i % 5 == 4, stratified
  start, gaussian proposals of step 0.09, n_moves 60, nmax 34, 100 sweeps.

With ``--pressure P`` the workload runs in the NPT ensemble
(``mcjax_torch.ops.npt.run_npt``, the counterpart of mcjax's ``--pressure``,
``--dlnv-max`` and ``--volume-every``): an ln-V volume move after every
``--volume-every``-th sweep, of half-width ``--dlnv-max``, at pressure P.

Timing uses CUDA events around a timed run of ``--sweeps`` sweeps that
follows a warm-up run of the same length.

    python -m mcjax_torch.bench [--workload {hard-disk,lj3d,ka3d}] [--n N]
                                [--phi 0.5] [--wfac 2.0] [--nmax NMAX]
                                [--moves M] [--sweeps S] [--seed 0]
                                [--pressure P [--dlnv-max 0.02]
                                 [--volume-every 1]]

Prints ONE JSON line: metric, value, unit, vs_baseline (against the
reference's 2.25e4 trial moves/s, BASELINE.md), plus ms per sweep,
overflow, acceptance and the device name; ka3d adds the A and B counts
after the run. An NPT run adds the volume moves' acceptance over both
runs, the final volume, scale and density, and the carried energy against
the float64 cell total at the final scale.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.state import SimState, init_state
from mcjax_torch.models.mixtures import LJMixture, kob_andersen
from mcjax_torch.models.potentials import HardSphere, LennardJones, Potential
from mcjax_torch.ops import cells
from mcjax_torch.ops.mixture import init_mixture_state, species_counts
from mcjax_torch.ops.npt import (NPTMetrics, NPTState, VolumeHook, init_npt,
                                 run_npt)
from mcjax_torch.ops.random import TorchRandoms
from mcjax_torch.ops.sweep import SweepMetrics, run_sweeps, total_energy_cells

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


def build_ka3d(n_atoms: int, nmax: int, n_moves: int, seed: int = 0,
               device: str | torch.device | None = None
               ) -> tuple[SimConfig, LJMixture, SimState]:
    """The Kob-Andersen system of bench.py's ``bench_ka3d``, on ``device``:
    rho 1.2, cells at least the largest pair cutoff (2.5) wide, an even
    count per side, species 1 (B) where i % 5 == 4, stratified start."""
    ka = kob_andersen()
    rho = 1.2
    box = (n_atoms / rho) ** (1.0 / 3.0)
    cps = int(box // ka.r_cut)
    cps -= cps % 2
    cfg = SimConfig(dim=3, n_atoms=n_atoms, box_length=box,
                    cells_per_side=cps, nmax=nmax, n_moves=n_moves,
                    proposal="gaussian", step_size=0.09, beta=1.0 / 0.8,
                    seed=seed)
    cfg.validate_against(ka.r_cut)
    dev = resolve_device(device)
    species = (torch.arange(n_atoms, device=dev) % 5 == 4).to(torch.int32)
    state = init_mixture_state(cfg, cells.stratified_positions(cfg, dev),
                               species, dev)
    return cfg, ka, state


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
    return rate_result(cfg, label, sweeps, seconds, state, m), state, warm, m


def rate_result(cfg: SimConfig, label: str, sweeps: int, seconds: float,
                state: SimState, m: SweepMetrics) -> dict:
    """The JSON result of a timed run of ``sweeps`` sweeps (metrics ``m``)
    that took ``seconds`` on the state's device."""
    proposed = int(m.proposed.sum())
    accepted = int(m.accepted.sum())
    moves_per_s = proposed / seconds
    return {
        "metric": label,
        "value": moves_per_s,
        "unit": "moves/s",
        "vs_baseline": moves_per_s / REFERENCE_MOVES_PER_S,
        "n_moves": cfg.n_moves,
        "sweeps": sweeps,
        "seconds": seconds,
        "ms_per_sweep": 1e3 * seconds / sweeps,
        "acceptance": accepted / max(proposed, 1),
        "overflow": bool(state.overflow),
        "device": torch.cuda.get_device_name(state.pos.device),
    }


def timed_npt_run(cfg: SimConfig, pot: Potential, state: SimState,
                  sweeps: int, seed: int, label: str, pressure: float,
                  dlnv_max: float, volume_every: int,
                  volume_hook: VolumeHook | None = None
                  ) -> tuple[dict, NPTState, NPTMetrics, NPTMetrics]:
    """``timed_run`` in the NPT ensemble: a warm-up ``run_npt`` of
    ``sweeps`` sweeps (its volume moves call ``volume_hook``), then a timed
    one of as many. The energy is anchored once, before the warm-up, and
    carried through both runs, so the timed window holds the sweeps alone.
    Returns (result dict, final NPT state, warm-up metrics, timed-run
    metrics)."""
    dev = state.pos.device
    randoms = TorchRandoms(torch.Generator(dev).manual_seed(seed))
    nst = init_npt(state)
    nst, warm = run_npt(cfg, pot, nst, pressure, sweeps, randoms, dlnv_max,
                        volume_every, volume_hook=volume_hook)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    nst, m = run_npt(cfg, pot, nst, pressure, sweeps, randoms, dlnv_max,
                     volume_every, u0=warm.energy[-1])
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3
    result = rate_result(cfg, label, sweeps, seconds, nst.sim, m.sweep)
    # both runs: sweep counts 0 to 2 sweeps - 1
    attempted = sum((s + 1) % volume_every == 0 for s in range(2 * sweeps))
    taken = int(warm.vol_accepted.sum()) + int(m.vol_accepted.sum())
    volume = float(m.volume[-1])
    carried = float(m.energy[-1])
    exact = float(total_energy_cells(cfg, pot, nst.sim.pos, nst.sim.occ,
                                     torch.float64, nst.scale))
    result.update(
        pressure=pressure, dlnv_max=dlnv_max, volume_every=volume_every,
        volume_moves=attempted, volume_accepted=taken,
        volume_acceptance=taken / max(attempted, 1),
        volume_final=volume, volume_start=cfg.box_length ** cfg.dim,
        scale_final=float(nst.scale), log_scale_final=float(nst.log_scale),
        density_final=cfg.n_atoms / volume, carried_energy=carried,
        energy_f64=exact,
        carried_energy_rel_err=abs(carried - exact) / max(1.0, abs(exact)))
    return result, nst, warm, m


def run_bench(n_atoms: int | None = None, phi: float = 0.5,
              wfac: float = 2.0, nmax: int | None = None,
              n_moves: int | None = None, sweeps: int | None = None,
              seed: int = 0
              ) -> tuple[dict, SimConfig, HardSphere, SimState, SweepMetrics,
                         SweepMetrics]:
    """The hard-disk benchmark on the GPU (warm-up, then ``sweeps`` timed;
    ``build_workload``'s defaults where an argument is None).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("hard-disk", n_atoms, nmax, n_moves, sweeps, seed, phi,
                   wfac)


def run_bench_lj3d(n_atoms: int | None = None, nmax: int | None = None,
                   n_moves: int | None = None, sweeps: int | None = None,
                   seed: int = 0
                   ) -> tuple[dict, SimConfig, LennardJones, SimState,
                              SweepMetrics, SweepMetrics]:
    """The 3D LJ benchmark on the GPU (warm-up, then ``sweeps`` timed;
    defaults as ``run_bench``'s).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("lj3d", n_atoms, nmax, n_moves, sweeps, seed)


def run_bench_ka3d(n_atoms: int | None = None, nmax: int | None = None,
                   n_moves: int | None = None, sweeps: int | None = None,
                   seed: int = 0
                   ) -> tuple[dict, SimConfig, LJMixture, SimState,
                              SweepMetrics, SweepMetrics]:
    """The Kob-Andersen benchmark on the GPU (warm-up, then ``sweeps``
    timed; defaults as ``run_bench``'s); the result also counts species A
    and B after the run.

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("ka3d", n_atoms, nmax, n_moves, sweeps, seed)


def run_nvt(workload: str, n_atoms: int | None = None,
            nmax: int | None = None, n_moves: int | None = None,
            sweeps: int | None = None, seed: int = 0, phi: float = 0.5,
            wfac: float = 2.0
            ) -> tuple[dict, SimConfig, Potential, SimState, SweepMetrics,
                       SweepMetrics]:
    """A workload's NVT benchmark on the GPU (``timed_run``; the workload's
    defaults where an argument is None); a mixture's result also counts
    species A and B after the run."""
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state, label = build_workload(workload, n_atoms, nmax, n_moves,
                                            seed, phi, wfac, dev)
    result, state, warm, m = timed_run(cfg, pot, state,
                                       sweeps or DEFAULT_SWEEPS[workload],
                                       seed, label)
    count_species(result, cfg, pot, state)
    return result, cfg, pot, state, warm, m


def count_species(result: dict, cfg: SimConfig, pot: Potential,
                  state: SimState) -> None:
    """Add a mixture state's A and B counts to ``result``."""
    if getattr(pot, "is_mixture", False):
        n_a, n_b = species_counts(cfg, state.pos, state.occ, 2).tolist()
        result.update(n_a=n_a, n_b=n_b)


def build_workload(workload: str, n_atoms: int | None = None,
                   nmax: int | None = None, n_moves: int | None = None,
                   seed: int = 0, phi: float = 0.5, wfac: float = 2.0,
                   device: str | torch.device | None = None
                   ) -> tuple[SimConfig, Potential, SimState, str]:
    """(cfg, pot, initial state, label) of a workload at its defaults where
    an argument is None."""
    if workload == "lj3d":
        cfg, pot, state = build_lj3d(n_atoms or 1_000_000, nmax or 24,
                                     n_moves or 60, seed, device)
        label = "3D LJ MC trial moves/sec/chip (N=%d, rho=0.8, cuda)"
    elif workload == "ka3d":
        cfg, pot, state = build_ka3d(n_atoms or 1_000_000, nmax or 34,
                                     n_moves or 60, seed, device)
        label = ("Kob-Andersen 80:20 mixture trial moves/sec/chip (N=%d, "
                 "rho=1.2, T=0.8, cuda)")
    elif workload == "hard-disk":
        cfg, pot, state = build(n_atoms or 1 << 20, phi, wfac, nmax or 7,
                                n_moves or 64, seed, device)
        label = ("hard-disk MC trial moves/sec/chip (N=%d, "
                 f"phi={phi:.2f}, cuda)")
    else:
        raise ValueError(f"unknown workload {workload!r}")
    return cfg, pot, state, label % cfg.n_atoms


DEFAULT_SWEEPS = {"hard-disk": 100, "lj3d": 30, "ka3d": 100}


def run_bench_npt(workload: str, pressure: float, dlnv_max: float = 0.02,
                  volume_every: int = 1, n_atoms: int | None = None,
                  nmax: int | None = None, n_moves: int | None = None,
                  sweeps: int | None = None, seed: int = 0,
                  phi: float = 0.5, wfac: float = 2.0,
                  volume_hook: VolumeHook | None = None
                  ) -> tuple[dict, SimConfig, Potential, NPTState, NPTMetrics,
                             NPTMetrics]:
    """A workload in the NPT ensemble on the GPU (warm-up, then ``sweeps``
    timed; ``timed_npt_run``). Returns (result dict, cfg, pot, final NPT
    state, warm-up metrics, timed-run metrics)."""
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state, label = build_workload(workload, n_atoms, nmax, n_moves,
                                            seed, phi, wfac, dev)
    label = label.replace(", cuda)", f", NPT P={pressure:g}, cuda)")
    result, nst, warm, m = timed_npt_run(
        cfg, pot, state, sweeps or DEFAULT_SWEEPS[workload], seed, label,
        pressure, dlnv_max, volume_every, volume_hook)
    count_species(result, cfg, pot, nst.sim)
    return result, cfg, pot, nst, warm, m


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("hard-disk", "lj3d", "ka3d"),
                    default="hard-disk")
    ap.add_argument("--n", type=int, default=None,
                    help="atoms (1048576 hard-disk, 1000000 lj3d and ka3d)")
    ap.add_argument("--phi", type=float, default=0.5, help="hard-disk only")
    ap.add_argument("--wfac", type=float, default=2.0,
                    help="hard-disk cell width in diameters (>= 1)")
    ap.add_argument("--nmax", type=int, default=None, help="7 / 24 / 34")
    ap.add_argument("--moves", type=int, default=None, help="64 / 60 / 60")
    ap.add_argument("--sweeps", type=int, default=None,
                    help="100 / 30 / 100")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pressure", type=float, default=None,
                    help="run in the NPT ensemble at this pressure")
    ap.add_argument("--dlnv-max", type=float, default=0.02,
                    help="NPT: half-width of the ln V proposal")
    ap.add_argument("--volume-every", type=int, default=1,
                    help="NPT: a volume move after every k-th sweep")
    args = ap.parse_args(argv)
    if args.pressure is not None:
        result, *_ = run_bench_npt(
            args.workload, args.pressure, args.dlnv_max, args.volume_every,
            args.n, args.nmax, args.moves, args.sweeps, args.seed, args.phi,
            args.wfac)
    else:
        result, *_ = run_nvt(args.workload, args.n, args.nmax, args.moves,
                             args.sweeps, args.seed, args.phi, args.wfac)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
