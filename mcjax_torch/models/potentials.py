"""Pair potentials (twin of ``mcjax.models.potentials``; hard core only).

``pair_energy(r2)`` is the finite part and ``overlap(r2)`` flags forbidden
configurations. Only ``HardSphere`` is ported so far; the energetic models
come with the Lennard-Jones slice.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class Potential(Protocol):
    """Structural interface all models satisfy."""

    r_cut: float
    has_energy: bool      # False for pure hard-core models (skip exp in accept)
    has_hard_core: bool   # True if overlap() can ever be True

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor: ...

    def overlap(self, r2: torch.Tensor) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class HardSphere:
    """Hard disks (2D) / hard spheres (3D): forbidden if r < diameter."""

    diameter: float = 1.0
    has_energy: bool = dataclasses.field(default=False, init=False)
    has_hard_core: bool = dataclasses.field(default=True, init=False)

    @property
    def r_cut(self) -> float:
        return self.diameter

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(r2)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return r2 < self.diameter * self.diameter


def pair_interaction(pot: Potential, r2: torch.Tensor, valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked (energy, overlap) terms for an array of squared distances."""
    e = torch.where(valid, pot.pair_energy(r2), 0.0)
    ov = valid & pot.overlap(r2)
    return e, ov
