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

With a field flag the workload runs under an external one-body field
(``mcjax_torch.ops.extfield``), with mcjax's flags and meaning
(``mcjax/cli.py``): ``--trap K[,KY,...]`` a harmonic trap at the origin,
``--gravity G`` g x along ``--field-axis`` (default: the last axis),
``--species-gravity G0,G1`` per-species gravity (mixtures), ``--walls
LO,HI[,DIAM...]`` hard slit walls on that axis (one contact diameter, or
one a species). A walled run starts from the workload's own start with its
wall-axis coordinate scaled about 0 into the open slab. The sub-steps run
the kernels' field forms; the frame origin moves on the device with the
grid shift.

The draws follow mcjax's bench defaults (``bench.py --in-kernel-rng``):
``--in-kernel-rng``, the default, runs the sub-step kernels' Philox forms,
which generate every move's draws in registers from the keyed stream of
``mcjax_torch.ops.random.PhiloxRandoms``, with gaussian proposals the
Irwin-Hall sum of ``--ih-k`` 16-bit halves (8 for lj3d and ka3d, 12
otherwise, as mcjax's bench sets it); ``--host-rng`` draws them with
PyTorch's generators into memory (``TorchRandoms``) for the kernels'
host-random forms. An NPT or field run always takes host draws, and says
so in ``rng_note``: NPT has no in-kernel form in mcjax, and the field
forms' Philox draws are later work.

Timing uses CUDA events around a timed run of ``--sweeps`` sweeps that
follows a warm-up run of the same length.

    python -m mcjax_torch.bench [--workload {hard-disk,lj3d,ka3d}] [--n N]
                                [--phi 0.5] [--wfac 2.0] [--nmax NMAX]
                                [--moves M] [--sweeps S] [--seed 0]
                                [--pressure P [--dlnv-max 0.02]
                                 [--volume-every 1]]
                                [--trap K] [--gravity G]
                                [--species-gravity G0,G1]
                                [--walls LO,HI[,DIAM...]] [--field-axis A]
                                [--in-kernel-rng | --host-rng] [--ih-k K]
                                [--no-rng-gate]

Prints ONE JSON line: metric, value, unit, vs_baseline (against the
reference's 2.25e4 trial moves/s, BASELINE.md), plus ms per sweep,
overflow, acceptance, the draws (``rng``: "in-kernel" or "host", and
``ih_k``), the device name and the torch and CUDA versions; ka3d adds the
A and B counts after the run. A run with in-kernel draws also runs the
statistical gate of those draws in the same process
(``mcjax_torch.utils.rng_gate``, at its full sizes, as mcjax's bench
records its ``rng_gate``) and adds its summary as ``rng_gate``; a run
with host draws (``--host-rng``, NPT, a field) or ``--no-rng-gate``
records "skipped", as mcjax's bench does without in-kernel draws. An NPT run
adds the volume moves' acceptance over both runs, the final volume, scale
and density, and the carried energy against
the float64 cell total at the final scale. A field run adds the pair and
field energies after the run (float64), the density of the slab between
the walls, the frame origin, and the carried energy (the start's float64
pair + field total plus every summed dE) against the float64 pair + field
total after the run.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.state import SimState, init_state
from mcjax_torch.models import fields
from mcjax_torch.models.mixtures import LJMixture, kob_andersen
from mcjax_torch.models.potentials import HardSphere, LennardJones, Potential
from mcjax_torch.ops import cells
from mcjax_torch.ops.extfield import (field_violations, run_field_sweeps,
                                      total_field_energy_cells)
from mcjax_torch.ops.mixture import init_mixture_state, species_counts
from mcjax_torch.ops.npt import (NPTMetrics, NPTState, VolumeHook, init_npt,
                                 run_npt)
from mcjax_torch.ops.random import PhiloxRandoms, TorchRandoms
from mcjax_torch.ops.sweep import SweepMetrics, run_sweeps, total_energy_cells

REFERENCE_MOVES_PER_S = 2.25e4  # BASELINE.md
RNG_MODES = ("in-kernel", "host")
# Irwin-Hall order of gaussian proposals: mcjax's bench sets 8 for its 3D
# workloads and keeps the library default, 12, elsewhere.
DEFAULT_IH_K = {"hard-disk": 12, "lj3d": 8, "ka3d": 8}
HOST_ONLY_NOTE = {
    "npt": "host draws: mcjax has no in-kernel-RNG NPT form",
    "field": "host draws: the field forms take no in-kernel draws yet",
}


def make_randoms(rng: str, seed: int, device: torch.device, ih_k: int):
    """The provider of a run's draws: ``PhiloxRandoms`` for the kernels'
    in-kernel (Philox) forms, ``TorchRandoms`` for host draws."""
    if rng == "in-kernel":
        return PhiloxRandoms(seed, device, ih_k)
    if rng == "host":
        return TorchRandoms(torch.Generator(device).manual_seed(seed))
    raise ValueError(f"rng must be one of {RNG_MODES}, got {rng!r}")


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
              seed: int, label: str, rng: str = "in-kernel", ih_k: int = 12
              ) -> tuple[dict, SimState, SweepMetrics, SweepMetrics]:
    """Warm-up run of ``sweeps`` sweeps, then a timed run of as many, on the
    state's (CUDA) device, with the draws of ``rng`` (``make_randoms``).
    Returns (result dict, final state, warm-up metrics, timed-run
    metrics)."""
    dev = state.pos.device
    randoms = make_randoms(rng, seed, dev, ih_k)
    state, warm = run_sweeps(cfg, pot, state, sweeps, randoms)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, m = run_sweeps(cfg, pot, state, sweeps, randoms)
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3
    result = rate_result(cfg, label, sweeps, seconds, state, m)
    result.update(rng=rng, ih_k=ih_k if rng == "in-kernel" else None)
    return result, state, warm, m


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
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
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
    result.update(rng="host", ih_k=None, rng_note=HOST_ONLY_NOTE["npt"])
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
              seed: int = 0, rng: str = "in-kernel", ih_k: int | None = None
              ) -> tuple[dict, SimConfig, HardSphere, SimState, SweepMetrics,
                         SweepMetrics]:
    """The hard-disk benchmark on the GPU (warm-up, then ``sweeps`` timed;
    ``build_workload``'s defaults where an argument is None; draws as
    ``run_nvt``'s).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("hard-disk", n_atoms, nmax, n_moves, sweeps, seed, phi,
                   wfac, rng, ih_k)


def run_bench_lj3d(n_atoms: int | None = None, nmax: int | None = None,
                   n_moves: int | None = None, sweeps: int | None = None,
                   seed: int = 0, rng: str = "in-kernel",
                   ih_k: int | None = None
                   ) -> tuple[dict, SimConfig, LennardJones, SimState,
                              SweepMetrics, SweepMetrics]:
    """The 3D LJ benchmark on the GPU (warm-up, then ``sweeps`` timed;
    defaults as ``run_bench``'s).

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("lj3d", n_atoms, nmax, n_moves, sweeps, seed, rng=rng,
                   ih_k=ih_k)


def run_bench_ka3d(n_atoms: int | None = None, nmax: int | None = None,
                   n_moves: int | None = None, sweeps: int | None = None,
                   seed: int = 0, rng: str = "in-kernel",
                   ih_k: int | None = None
                   ) -> tuple[dict, SimConfig, LJMixture, SimState,
                              SweepMetrics, SweepMetrics]:
    """The Kob-Andersen benchmark on the GPU (warm-up, then ``sweeps``
    timed; defaults as ``run_bench``'s); the result also counts species A
    and B after the run.

    Returns (result dict, cfg, pot, final state, warm-up metrics, timed-run
    metrics).
    """
    return run_nvt("ka3d", n_atoms, nmax, n_moves, sweeps, seed, rng=rng,
                   ih_k=ih_k)


def run_nvt(workload: str, n_atoms: int | None = None,
            nmax: int | None = None, n_moves: int | None = None,
            sweeps: int | None = None, seed: int = 0, phi: float = 0.5,
            wfac: float = 2.0, rng: str = "in-kernel",
            ih_k: int | None = None
            ) -> tuple[dict, SimConfig, Potential, SimState, SweepMetrics,
                       SweepMetrics]:
    """A workload's NVT benchmark on the GPU (``timed_run``; the workload's
    defaults where an argument is None, ``DEFAULT_IH_K`` for ``ih_k``),
    with in-kernel (the default) or host draws; a mixture's result also
    counts species A and B after the run."""
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state, label = build_workload(workload, n_atoms, nmax, n_moves,
                                            seed, phi, wfac, dev)
    result, state, warm, m = timed_run(
        cfg, pot, state, sweeps or DEFAULT_SWEEPS[workload], seed, label,
        rng, ih_k or DEFAULT_IH_K[workload])
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
# Cell capacity of a field run: slit walls hold the same N in less volume
# (3.3 % less at lj3d's box with walls 1.25 inside each face, 3.7 % at
# ka3d's), the start is the lattice compressed along the wall axis (cells
# of 3 and 4 of its layers) and the fluid layers at the walls, so the 3D
# cells hold more than in the bulk: a walled run of 12^3 cells of the
# bulk's width reached 21 (lj3d) and 33 (ka3d) a cell.
DEFAULT_FIELD_NMAX = {"hard-disk": 7, "lj3d": 28, "ka3d": 40}


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


def field_from_args(args, dim: int, mixture: bool):
    """The external field of mcjax's CLI flags (``mcjax/cli.py::
    field_from_args``): None without a field flag; several compose in a
    ``CompositeField`` (trap, gravity, walls, in that order)."""
    fs = []
    axis = args.field_axis if args.field_axis is not None else dim - 1
    if args.trap is not None:
        k = tuple(float(v) for v in args.trap.split(","))
        fs.append(fields.HarmonicTrap(stiffness=k if len(k) > 1 else k[0],
                                      dim=dim))
    if args.species_gravity is not None:
        if not mixture:
            raise SystemExit("--species-gravity needs a mixture model "
                             "(single species: --gravity)")
        g = tuple(float(v) for v in args.species_gravity.split(","))
        fs.append(fields.SpeciesField(fields.LinearField(g=1.0, axis=axis),
                                      g))
    elif args.gravity is not None:
        fs.append(fields.LinearField(g=args.gravity, axis=axis))
    if args.walls is not None:
        parts = [float(v) for v in args.walls.split(",")]
        if len(parts) < 2:
            raise SystemExit("--walls needs LO,HI[,DIAM...]")
        lo, hi, diams = parts[0], parts[1], parts[2:]
        if len(diams) > 1:
            fs.append(fields.SlitWalls(lo=lo, hi=hi, axis=axis,
                                       diameters=tuple(diams)))
        else:
            fs.append(fields.SlitWalls(lo=lo, hi=hi, axis=axis,
                                       diameter=diams[0] if diams else 0.0))
    if not fs:
        return None
    return fs[0] if len(fs) == 1 else fields.CompositeField(tuple(fs))


def _walls(field) -> list:
    if isinstance(field, fields.CompositeField):
        return [w for f in field.fields for w in _walls(f)]
    return [field] if isinstance(field, fields.SlitWalls) else []


def slab_start(cfg: SimConfig, field, state: SimState, mixture: bool
               ) -> SimState:
    """A start for a walled run: the workload's start with each wall
    axis's coordinate scaled about 0, by the largest float32 factor below
    (min(hi, -lo) / (L/2)) (1 - 1e-6) of the allowed centers [lo, hi]
    (each species' bounds), so that every center lies inside the slab.
    Unchanged without walls."""
    walls = _walls(field)
    if not walls:
        return state
    r = cells.unbin(cfg, state.pos, state.occ)
    spec = r[:, cfg.dim] if mixture else None
    half = cfg.box_length / 2.0
    for w in walls:
        probe = torch.tensor([0.0, 1.0], device=r.device)
        lo, hi = w.bounds(probe, probe if mixture else None)
        lo, hi = float(lo.max()), float(hi.min())
        if not lo < 0.0 < hi:
            raise ValueError(f"{w!r}: the slab must hold the box center to "
                             "scale the start into it")
        f = min(hi, -lo) / half * (1.0 - 1e-6)
        r[:, w.axis] = r[:, w.axis] * f
    if mixture:
        return init_mixture_state(cfg, r[:, :cfg.dim], spec.to(torch.int32),
                                  r.device)
    return init_state(cfg, r.device, r[:, :cfg.dim])


def timed_field_run(cfg: SimConfig, pot: Potential, field, state: SimState,
                    sweeps: int, seed: int, label: str
                    ) -> tuple[dict, SimState, torch.Tensor, SweepMetrics,
                               SweepMetrics]:
    """``timed_run`` under ``field`` (``run_field_sweeps`` from origin 0):
    a warm-up run of ``sweeps`` sweeps, then a timed one of as many.
    Returns (result dict, final state, final origin, warm-up metrics,
    timed-run metrics)."""
    dev = state.pos.device
    f64 = torch.float64
    origin = torch.zeros(cfg.dim, dtype=torch.float32, device=dev)
    e_pair0 = float(total_energy_cells(cfg, pot, state.pos, state.occ, f64))
    e_field0 = float(total_field_energy_cells(cfg, field, state.pos,
                                              state.occ, origin, f64))
    randoms = TorchRandoms(torch.Generator(dev).manual_seed(seed))
    state, origin, warm = run_field_sweeps(cfg, pot, field, state, origin,
                                           sweeps, randoms)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, origin, m = run_field_sweeps(cfg, pot, field, state, origin,
                                        sweeps, randoms)
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3
    result = rate_result(cfg, label, sweeps, seconds, state, m)
    result.update(rng="host", ih_k=None, rng_note=HOST_ONLY_NOTE["field"])
    e_pair = float(total_energy_cells(cfg, pot, state.pos, state.occ, f64))
    e_field = float(total_field_energy_cells(cfg, field, state.pos,
                                             state.occ, origin, f64))
    carried = (e_pair0 + e_field0 + float(warm.delta_e.double().sum())
               + float(m.delta_e.double().sum()))
    exact = e_pair + e_field
    walls = _walls(field)
    width = min(w.hi for w in walls) - max(w.lo for w in walls) \
        if walls else cfg.box_length
    result.update(
        pair_energy=e_pair, field_energy=e_field,
        pair_energy_start=e_pair0, field_energy_start=e_field0,
        slab_density=cfg.n_atoms / (width * cfg.box_length ** (cfg.dim - 1)),
        origin=origin.tolist(),
        field_violations=int(field_violations(cfg, field, state.pos,
                                              state.occ, origin)),
        carried_energy=carried, energy_f64=exact,
        carried_energy_rel_err=abs(carried - exact) / max(1.0, abs(exact)))
    return result, state, origin, warm, m


def run_bench_field(workload: str, field, n_atoms: int | None = None,
                    nmax: int | None = None, n_moves: int | None = None,
                    sweeps: int | None = None, seed: int = 0,
                    phi: float = 0.5, wfac: float = 2.0
                    ) -> tuple[dict, SimConfig, Potential, SimState,
                               torch.Tensor, SweepMetrics, SweepMetrics]:
    """A workload under an external ``field`` on the GPU (warm-up, then
    ``sweeps`` timed; ``timed_field_run``), from ``slab_start``; nmax
    defaults to ``DEFAULT_FIELD_NMAX``. Returns (result dict, cfg, pot,
    final state, final origin, warm-up metrics, timed-run metrics)."""
    dev = resolve_device(None)          # the GPU; raises without one
    cfg, pot, state, label = build_workload(
        workload, n_atoms, nmax or DEFAULT_FIELD_NMAX[workload], n_moves,
        seed, phi, wfac, dev)
    mixture = getattr(pot, "is_mixture", False)
    state = slab_start(cfg, field, state, mixture)
    label = label.replace(", cuda)", ", field, cuda)")
    result, state, origin, warm, m = timed_field_run(
        cfg, pot, field, state, sweeps or DEFAULT_SWEEPS[workload], seed,
        label)
    count_species(result, cfg, pot, state)
    return result, cfg, pot, state, origin, warm, m


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("hard-disk", "lj3d", "ka3d"),
                    default="hard-disk")
    ap.add_argument("--n", type=int, default=None,
                    help="atoms (1048576 hard-disk, 1000000 lj3d and ka3d)")
    ap.add_argument("--phi", type=float, default=0.5, help="hard-disk only")
    ap.add_argument("--wfac", type=float, default=2.0,
                    help="hard-disk cell width in diameters (>= 1)")
    ap.add_argument("--nmax", type=int, default=None,
                    help="7 / 24 / 34 (under a field 7 / 28 / 40)")
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
    ap.add_argument("--trap", type=str, default=None, metavar="K[,KY,...]",
                    help="harmonic trap at the origin: scalar or per-axis "
                         "stiffness")
    ap.add_argument("--gravity", type=float, default=None, metavar="G",
                    help="linear field g*x along --field-axis")
    ap.add_argument("--species-gravity", type=str, default=None,
                    metavar="G0,G1", help="per-species gravity (ka3d)")
    ap.add_argument("--walls", type=str, default=None,
                    metavar="LO,HI[,DIAM...]",
                    help="hard slit walls on --field-axis; contact diameter "
                         "(one, or one per species)")
    ap.add_argument("--field-axis", type=int, default=None,
                    help="axis of --gravity / --walls (default: the last)")
    ap.add_argument("--in-kernel-rng", dest="rng", action="store_const",
                    const="in-kernel", default="in-kernel",
                    help="draws generated in the sub-step kernels (Philox; "
                         "the default, as mcjax's bench)")
    ap.add_argument("--host-rng", dest="rng", action="store_const",
                    const="host", help="draws made on the device by "
                                       "PyTorch's generators, in memory")
    ap.add_argument("--ih-k", type=int, default=None,
                    help="Irwin-Hall halves per gaussian component "
                         "(8 lj3d and ka3d, 12 otherwise)")
    ap.add_argument("--no-rng-gate", action="store_true",
                    help="skip the in-process statistical gate of the "
                         "in-kernel draws (rng_gate becomes 'skipped')")
    args = ap.parse_args(argv)
    ih_k = args.ih_k or DEFAULT_IH_K[args.workload]
    dim = 2 if args.workload == "hard-disk" else 3
    field = field_from_args(args, dim, args.workload == "ka3d")
    if field is not None:
        if args.pressure is not None:
            raise SystemExit("a field run is NVT (mcjax has no NPT run "
                             "under a field)")
        result, *_ = run_bench_field(args.workload, field, args.n, args.nmax,
                                     args.moves, args.sweeps, args.seed,
                                     args.phi, args.wfac)
    elif args.pressure is not None:
        result, *_ = run_bench_npt(
            args.workload, args.pressure, args.dlnv_max, args.volume_every,
            args.n, args.nmax, args.moves, args.sweeps, args.seed, args.phi,
            args.wfac)
    else:
        result, *_ = run_nvt(args.workload, args.n, args.nmax, args.moves,
                             args.sweeps, args.seed, args.phi, args.wfac,
                             args.rng, ih_k)
    if args.no_rng_gate or result["rng"] != "in-kernel":
        result["rng_gate"] = "skipped"
    else:
        from mcjax_torch.utils.rng_gate import run_gate
        result["rng_gate"] = run_gate(ih_k=ih_k, quiet=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
