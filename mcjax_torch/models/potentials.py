"""Pair potentials (twin of ``mcjax.models.potentials``).

``pair_energy(r2)`` is the finite part and ``overlap(r2)`` flags forbidden
configurations. Ported so far: ``HardSphere`` and ``LennardJones``. Every
operation is the one XLA on the CPU performs for the JAX package's model,
contractions included, so energies match it bit for bit.
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


def fma_f32(a: torch.Tensor | float, b: torch.Tensor | float,
            c: torch.Tensor | float) -> torch.Tensor:
    """a*b + c rounded once to float32 (computed in float64, then rounded).

    XLA on the CPU contracts a multiply feeding an add into one fused
    multiply-add at a few sites of the sub-step (the squared distance, the
    cell lower bound, the Lennard-Jones bracket). The product of two f32
    values is exact in f64, so this equals a true fma except where the f64
    sum rounds onto an f32 rounding midpoint (double rounding), which no
    test has met.
    """
    a, b, c = (torch.as_tensor(v, dtype=torch.float32).double()
               for v in (a, b, c))
    return (a * b + c).float()


def safe_inv(r2: torch.Tensor) -> torch.Tensor:
    """1/r2 guarded against the masked-garbage r2 = 0 entries (a correctly
    rounded division, as XLA computes it)."""
    return 1.0 / torch.clamp(r2, min=1e-12)


@dataclasses.dataclass(frozen=True)
class LennardJones:
    """Truncated LJ 12-6: 4 eps ((s/r)^12 - (s/r)^6) for r <= r_cut.

    ``shift=False`` is the reference's bare truncation; ``shift=True``
    subtracts the cutoff value so the potential is continuous. In float32:
    inv6 = (inv2 inv2) inv2 with inv2 = f32(s^2) / r2, then
    e = f32(4 eps) fma(inv6, inv6, -inv6), shifted as
    fma(f32(4 eps), bracket, -f32(shift value)), as XLA contracts it.
    """

    epsilon: float = 1.0
    sigma: float = 1.0
    r_cut: float = 2.5
    shift: bool = False
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)

    @property
    def shift_value(self) -> float:
        """The energy at the cutoff that ``shift=True`` subtracts (0 when
        unshifted), as the float64 value the JAX package rounds."""
        if not self.shift:
            return 0.0
        s6 = (self.sigma / self.r_cut) ** 6
        return 4.0 * self.epsilon * (s6 * s6 - s6)

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        """Pair energy at squared distance r2; float32 input is evaluated as
        XLA on the CPU does, float64 input in plain float64."""
        inv2 = (self.sigma * self.sigma) * safe_inv(r2)
        inv6 = inv2 * inv2 * inv2
        if r2.dtype == torch.float32:
            bracket = fma_f32(inv6, inv6, -inv6)
            if self.shift:
                e = fma_f32(4.0 * self.epsilon, bracket, -self.shift_value)
            else:
                e = (4.0 * self.epsilon) * bracket
        else:
            e = (4.0 * self.epsilon) * (inv6 * inv6 - inv6) - self.shift_value
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)


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
