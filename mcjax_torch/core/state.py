"""Simulation state as torch tensors (twin of ``mcjax.core.state``).

Layout is the JAX package's color-blocked slab, so states convert 1:1:

    pos[color, dim, nmax, b1, ..., b_dim]   float32   (coordinate planes)
    occ[color, b1, ..., b_dim]              int32

Slots with index >= occ are garbage and always masked. The JAX package keeps
a Threefry key in the state; the port takes its randomness from a provider
passed to ``run_sweeps`` instead (``mcjax_torch.ops.random``), so the state
holds no generator.
"""

from __future__ import annotations

import dataclasses

import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import resolve_device


@dataclasses.dataclass
class SimState:
    """Full MC state.

    Attributes:
      pos: [n_colors, dim, nmax, *block_shape] float32 coordinate planes,
        global coordinates in [-L/2, L/2).
      occ: [n_colors, *block_shape] int32 per-cell particle counts.
      sweep: number of completed sweeps (a host int: the schedule is decided
        on the host, so reading it never waits for the device).
      overflow: 0-d bool tensor on the state's device; sticky flag, True if
        any cell ever exceeded nmax capacity.
    """

    pos: torch.Tensor
    occ: torch.Tensor
    sweep: int
    overflow: torch.Tensor

    @property
    def n_atoms(self) -> torch.Tensor:
        return self.occ.sum()


def zeros_state(cfg: SimConfig, device: str | torch.device | None = None
                ) -> SimState:
    """Empty state with correctly-shaped buffers."""
    dev = resolve_device(device)
    return SimState(
        pos=torch.zeros((cfg.n_colors, cfg.dim, cfg.nmax, *cfg.block_shape),
                        dtype=torch.float32, device=dev),
        occ=torch.zeros((cfg.n_colors, *cfg.block_shape), dtype=torch.int32,
                        device=dev),
        sweep=0,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )


def init_state(cfg: SimConfig, device: str | torch.device | None = None,
               positions: torch.Tensor | None = None) -> SimState:
    """Initial state: lattice (or given [N, dim]) positions binned into slabs.

    Runs on CUDA unless ``device`` names another device.
    """
    from mcjax_torch.ops import cells  # ops depends on core, not vice versa

    dev = resolve_device(device)
    if positions is None:
        positions = cells.lattice_positions(cfg, dev)
    pos, occ, overflow = cells.bin_particles(cfg, positions.to(dev))
    return SimState(pos=pos, occ=occ, sweep=0, overflow=overflow)
