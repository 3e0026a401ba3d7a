"""Statistical gate of the kernels' in-kernel (Philox) draws, the port of
``scripts/validate_in_kernel_rng.py``.

The host-random path (``TorchRandoms``, draws materialized in memory) is
the bitwise bridge to the JAX package; the Philox form draws other
numbers, so it is held to the host path statistically, by mcjax's own
checks and thresholds:

1. hard disks (262,144 at phi 0.5, 60 sweeps of 16 moves): acceptance
   parity between the two draw sources (pooled two-proportion z < 10, a
   generous budget since moves within a chain are correlated) and the
   contact equation of state, Z from g(d+), within 5 %;
2. 3D Lennard-Jones (110,592 atoms at rho 0.8, 20^3 cells, nmax 25, 160
   sweeps of 10 gaussian moves from the stratified start, near
   equilibrium): capacity (no overflow, every atom kept) in both modes,
   acceptance within 0.01, the dE anchor (the start's energy plus the
   summed dE against the float64 cell total) within rel 1e-3 in both
   modes, and the energy per atom within 0.05;
3. Kob-Andersen 80:20 (ka3d's density and cell width at 16^3 cells, N =
   87,793, nmax 34, 100 sweeps of 10 moves): capacity, acceptance within
   0.01 and the dE anchor in both modes. Its energy is not compared: a
   glass at beta 1.25 is still relaxing.

``run_gate()`` runs it on the card (``device=None``) and returns a
JSON-able dict; ``sizes`` and the providers can be swapped for a small
run on the CPU, whose plain path materializes the same Philox draws.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from mcjax_torch.core.device import resolve_device
from mcjax_torch.ops.random import PhiloxRandoms, TorchRandoms
from mcjax_torch.ops.sweep import run_sweeps, total_energy_cells
from mcjax_torch.utils.observables import hard_disk_eos_state

# mcjax's full sizes (scripts/validate_in_kernel_rng.py), and the ka3d case.
FULL = dict(disks=262_144, disk_sweeps=60, disk_moves=16,
            lj=110_592, lj_sweeps=160, lj_moves=10,
            ka=87_793, ka_sweeps=100, ka_moves=10, ka_nmax=34)

Factory = Callable[[int, torch.device, int], object]


def philox_factory(seed: int, device: torch.device, ih_k: int):
    return PhiloxRandoms(seed, device, ih_k)


def host_factory(seed: int, device: torch.device, ih_k: int):
    return TorchRandoms(torch.Generator(device).manual_seed(seed))


class Gate:
    """Collects named pass/fail checks; prints one line per check."""

    def __init__(self, tag: str, quiet: bool = False):
        self.tag = tag
        self.quiet = quiet
        self.failures: list[str] = []
        self.results: list[dict] = []

    def check(self, name: str, ok: bool, value: float, detail: str) -> None:
        """Record check ``name``: ``value`` is the statistic its threshold
        judges (z, a relative gap, an absolute or, for an acceptance, the
        signed difference in-kernel - host)."""
        self.results.append({"name": name, "ok": bool(ok),
                             "value": float(value), "detail": detail})
        if not ok:
            self.failures.append(name)
        if not self.quiet:
            print(f"{'PASS' if ok else 'FAIL'}  {name} [{self.tag}]: "
                  f"{detail}", flush=True)

    @property
    def ok(self) -> bool:
        return bool(self.results) and not self.failures


def _acc_rate(m) -> tuple[float, int]:
    a, p = int(m.accepted.sum()), int(m.proposed.sum())
    return a / p, p


def _both(build, sweeps: int, seed: int, device, ih_k: int,
          host: Factory, philox: Factory) -> dict:
    """The same start run under both draw sources: {mode: (cfg, pot,
    start energy (float64), final state, metrics)}."""
    out = {}
    for mode, factory in (("host", host), ("in-kernel", philox)):
        cfg, pot, st = build()
        e0 = float(total_energy_cells(cfg, pot, st.pos, st.occ,
                                      torch.float64)) if pot.has_energy \
            else 0.0
        st, m = run_sweeps(cfg, pot, st, sweeps, factory(seed, device, ih_k))
        out[mode] = (cfg, pot, e0, st, m)
    return out


def hard_disk_case(g: Gate, device, sizes: dict, ih_k: int, seed: int,
                   host: Factory, philox: Factory) -> None:
    from mcjax_torch import bench
    n = sizes["disks"]
    runs = _both(lambda: bench.build(n, 0.5, 2.0, 7, sizes["disk_moves"],
                                     device=device),
                 sizes["disk_sweeps"], seed, device, ih_k, host, philox)
    (r_h, p_h), (r_k, p_k) = (_acc_rate(runs[k][4])
                              for k in ("host", "in-kernel"))
    pool = (r_h + r_k) / 2
    se = math.sqrt(pool * (1 - pool) * (1 / p_h + 1 / p_k))
    z = abs(r_h - r_k) / se
    g.check("hard-disk acceptance parity", z < 10.0, z,
            f"host {r_h:.5f} vs in-kernel {r_k:.5f} (z={z:.2f}, "
            f"{p_h:.2e} proposals each)")
    z_h, z_k = (hard_disk_eos_state(cfg, (st.pos, st.occ), 1.0)
                for cfg, _, _, st, _ in (runs["host"], runs["in-kernel"]))
    gap = abs(z_h - z_k) / z_h
    g.check("hard-disk contact EOS parity", gap < 0.05, gap,
            f"Z host {z_h:.3f} vs in-kernel {z_k:.3f}")


def _energetic_checks(g: Gate, label: str, runs: dict, n: int) -> dict:
    """Capacity, acceptance parity and the dE anchor in both modes;
    returns each mode's final energy per atom."""
    per_atom = {}
    for tag in ("host", "in-kernel"):
        cfg, _, _, st, _ = runs[tag]
        atoms = int(st.occ.sum())
        g.check(f"{label} capacity ({tag} RNG)",
                not bool(st.overflow) and atoms == n, n - atoms,
                f"overflow={bool(st.overflow)} atoms={atoms}/{n} "
                f"(nmax={cfg.nmax})")
    (r_h, _), (r_k, _) = (_acc_rate(runs[k][4])
                          for k in ("host", "in-kernel"))
    g.check(f"{label} acceptance parity", abs(r_h - r_k) < 0.01, r_k - r_h,
            f"host {r_h:.5f} vs in-kernel {r_k:.5f}")
    for tag in ("host", "in-kernel"):
        cfg, pot, e0, st, m = runs[tag]
        e_tr = e0 + float(m.delta_e.double().sum())
        e_ex = float(total_energy_cells(cfg, pot, st.pos, st.occ,
                                        torch.float64))
        rel = abs(e_tr - e_ex) / max(abs(e_ex), 1.0)
        g.check(f"{label} dE-anchor ({tag} RNG)", rel < 1e-3, rel,
                f"trace {e_tr:.1f} vs exact {e_ex:.1f} (rel {rel:.2e})")
        per_atom[tag] = e_ex / n
    return per_atom


def lj_case(g: Gate, device, sizes: dict, ih_k: int, seed: int,
            host: Factory, philox: Factory) -> None:
    from mcjax_torch import bench
    n, rho = sizes["lj"], 0.8
    cps = int((n / rho) ** (1.0 / 3.0) // 2.5)
    cps -= cps % 2
    # mcjax's capacity rule: 1.8 x the mean occupancy, at least 24
    nmax = max(24, int(math.ceil(1.8 * n / cps ** 3)))
    runs = _both(lambda: bench.build_lj3d(n, nmax, sizes["lj_moves"],
                                          device=device),
                 sizes["lj_sweeps"], seed, device, ih_k, host, philox)
    e = _energetic_checks(g, "3D LJ", runs, n)
    gap = abs(e["host"] - e["in-kernel"])
    g.check("3D LJ energy/atom parity", gap < 0.05, gap,
            f"host {e['host']:.4f} vs in-kernel {e['in-kernel']:.4f} "
            "(tol 0.05)")


def ka_case(g: Gate, device, sizes: dict, ih_k: int, seed: int,
            host: Factory, philox: Factory) -> None:
    from mcjax_torch import bench
    n = sizes["ka"]
    runs = _both(lambda: bench.build_ka3d(n, sizes["ka_nmax"],
                                          sizes["ka_moves"], device=device),
                 sizes["ka_sweeps"], seed, device, ih_k, host, philox)
    _energetic_checks(g, "ka3d", runs, n)


CASES = {"hard-disk": hard_disk_case, "lj": lj_case, "ka3d": ka_case}


def run_gate(ih_k: int = 8, device: str | torch.device | None = None,
             sizes: dict | None = None, quiet: bool = False, seed: int = 0,
             host: Factory = host_factory, philox: Factory = philox_factory,
             cases: tuple[str, ...] = tuple(CASES)) -> dict:
    """Run the gate's ``cases`` (all three by default) and return a
    JSON-able summary: ok, the Irwin-Hall order, the device, the sizes,
    every check (name, ok, the statistic it judged, detail) and the
    failures. ``philox`` and
    ``host`` make each mode's provider from (seed, device, ih_k)."""
    dev = resolve_device(device)
    sizes = dict(FULL if sizes is None else sizes)
    g = Gate(f"ih_k={ih_k} device={dev.type}", quiet=quiet)
    for name in cases:
        CASES[name](g, dev, sizes, ih_k, seed, host, philox)
    return {"ok": g.ok, "ih_k": ih_k, "device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "cases": list(cases), "sizes": sizes, "checks": g.results,
            "failures": g.failures}
