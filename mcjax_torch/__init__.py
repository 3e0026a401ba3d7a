"""mcjax_torch: the PyTorch / CUDA port of mcjax for NVIDIA Hopper.

Checkerboard-decomposed, cell-list Metropolis Monte Carlo on color-blocked
slabs, with the JAX package's state layout: hard disks and spheres, every
single-species pair model of the JAX package (Lennard-Jones, WCA, soft
spheres, square wells, Yukawa, Morse, polynomials in 1/r^2) in 2D and 3D,
and 3D binary Lennard-Jones mixtures (Kob-Andersen), in the NVT
ensemble and in the NPT one (ln-V volume moves, ``run_npt``), and under
external one-body fields (traps, gravity, slit walls:
``mcjax_torch.models.fields``, ``mcjax_torch.ops.extfield``), with the
draws generated inside the sub-step kernels from a keyed Philox stream
(``PhiloxRandoms``, mcjax's in-kernel PRNG form) or made in memory
(``TorchRandoms``). Each color
sub-step and each grid shift runs as a hand-written CUDA kernel on the
card; on the CPU the same entry points run plain PyTorch versions that
match the JAX package (bit for bit for hard disks; for the energetic models
bit for bit up to accept decisions at a near tie, since dE is summed in
another order). Entry points run on CUDA unless the
caller passes ``device="cpu"``.

This package imports torch, numpy and the standard library only.
"""

from mcjax_torch.convert import (potential_from_spec, potential_to_spec,
                                 state_from_numpy, state_to_numpy)
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.state import SimState, init_state, zeros_state
from mcjax_torch.models.mixtures import LJMixture, kob_andersen
from mcjax_torch.models.potentials import (WCA, HardSphere, LennardJones,
                                           Morse, PolynomialPotential,
                                           SoftSphere, SquareWell, Yukawa,
                                           fit_pair_polynomial)
from mcjax_torch.ops.mixture import init_mixture_state, unbin_mixture
from mcjax_torch.ops.npt import (NPTMetrics, NPTState, init_npt, npt_sweep,
                                 run_npt)
from mcjax_torch.ops.random import PhiloxRandoms, RandomProvider, TorchRandoms
from mcjax_torch.ops.sweep import (SweepMetrics, mc_sweep, run_sweeps,
                                   total_energy_cells)
from mcjax_torch.utils.debug import StateInvariantError, validate_state

__version__ = "0.1.0"

__all__ = [
    "HardSphere",
    "LJMixture",
    "LennardJones",
    "Morse",
    "NPTMetrics",
    "NPTState",
    "PhiloxRandoms",
    "PolynomialPotential",
    "RandomProvider",
    "SimConfig",
    "SimState",
    "SoftSphere",
    "SquareWell",
    "StateInvariantError",
    "SweepMetrics",
    "TorchRandoms",
    "WCA",
    "Yukawa",
    "fit_pair_polynomial",
    "init_mixture_state",
    "init_npt",
    "init_state",
    "kob_andersen",
    "mc_sweep",
    "npt_sweep",
    "potential_from_spec",
    "potential_to_spec",
    "run_npt",
    "run_sweeps",
    "state_from_numpy",
    "state_to_numpy",
    "total_energy_cells",
    "unbin_mixture",
    "validate_state",
    "zeros_state",
]
