"""mcjax_torch: the PyTorch / CUDA port of mcjax for NVIDIA Hopper.

Checkerboard-decomposed, cell-list Metropolis Monte Carlo on color-blocked
slabs, with the JAX package's state layout: 2D hard disks and 3D
Lennard-Jones so far. Each color sub-step and each grid shift runs as a
hand-written CUDA kernel on the card; on the CPU the same entry points run
plain PyTorch versions that match the JAX package (bit for bit for hard
disks; for Lennard-Jones bit for bit up to accept decisions at a near tie,
since dE is summed in another order). Entry points run on CUDA unless the
caller passes ``device="cpu"``.

This package imports torch, numpy and the standard library only.
"""

from mcjax_torch.convert import state_from_numpy, state_to_numpy
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.state import SimState, init_state, zeros_state
from mcjax_torch.models.potentials import HardSphere, LennardJones
from mcjax_torch.ops.random import RandomProvider, TorchRandoms
from mcjax_torch.ops.sweep import (SweepMetrics, mc_sweep, run_sweeps,
                                   total_energy_cells)
from mcjax_torch.utils.debug import StateInvariantError, validate_state

__version__ = "0.1.0"

__all__ = [
    "HardSphere",
    "LennardJones",
    "RandomProvider",
    "SimConfig",
    "SimState",
    "StateInvariantError",
    "SweepMetrics",
    "TorchRandoms",
    "init_state",
    "mc_sweep",
    "run_sweeps",
    "state_from_numpy",
    "state_to_numpy",
    "total_energy_cells",
    "validate_state",
    "zeros_state",
]
