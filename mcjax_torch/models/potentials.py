"""Pair potentials (twin of ``mcjax.models.potentials``).

``pair_energy(r2)`` is the finite part and ``overlap(r2)`` flags forbidden
configurations. Every single-species model of the JAX package is here:
``HardSphere``, ``LennardJones``, ``SoftSphere``, ``WCA``, ``SquareWell``,
``Yukawa``, ``Morse`` and ``PolynomialPotential`` (with
``fit_pair_polynomial``), and the registry that names them
(``potential_to_dict`` / ``potential_from_dict``). In float32 every
operation of the rational models is the one XLA on the CPU performs for the
JAX package's model, contractions included, so their energies match it bit
for bit. Yukawa and Morse call exp (and sqrt); torch's exp may differ from
XLA's by an ulp or two, and XLA folds Morse's constants at eps = 1, so
those two match it within a few ulps of the energy scale. The JAX
package's ``_pl`` approximate-reciprocal forms, which round as the TPU
does, are not ported: the port computes the exact forms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol, runtime_checkable

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class SoftSphere:
    """Inverse-power repulsion eps (sigma/r)^n, truncated at r_cut.

    Even exponents go by squaring, in the JAX package's order of products
    (no sum, so nothing to contract); an odd one is a float32 pow, which
    may differ from XLA's by an ulp.
    """

    epsilon: float = 1.0
    sigma: float = 1.0
    exponent: int = 12
    r_cut: float = 2.5
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        inv2 = (self.sigma * self.sigma) * safe_inv(r2)
        if self.exponent % 2 == 0:
            p, base, acc = self.exponent // 2, inv2, None
            while p:
                if p & 1:
                    acc = base if acc is None else acc * base
                base, p = base * base, p >> 1
            e = self.epsilon * acc
        else:
            e = self.epsilon * inv2 ** (self.exponent / 2.0)
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)


@dataclasses.dataclass(frozen=True)
class WCA:
    """Weeks-Chandler-Andersen: LJ truncated at 2^(1/6) sigma, shifted by
    eps. In float32 e = fma(f32(4 eps), fma(inv6, inv6, -inv6), f32(eps)),
    the two sites where XLA contracts it."""

    epsilon: float = 1.0
    sigma: float = 1.0
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)

    @property
    def r_cut(self) -> float:
        return 2.0 ** (1.0 / 6.0) * self.sigma

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        inv2 = (self.sigma * self.sigma) * safe_inv(r2)
        inv6 = inv2 * inv2 * inv2
        if r2.dtype == torch.float32:
            e = fma_f32(4.0 * self.epsilon, fma_f32(inv6, inv6, -inv6),
                        self.epsilon)
        else:
            e = 4.0 * self.epsilon * (inv6 * inv6 - inv6) + self.epsilon
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)


@dataclasses.dataclass(frozen=True)
class SquareWell:
    """Hard core at ``diameter`` with an attractive well of depth
    ``epsilon`` out to ``lam * diameter``. Energies inside the core are
    never sampled (the overlap rejects first), so pair_energy returns
    -epsilon there too, as the JAX package's does."""

    epsilon: float = 1.0
    diameter: float = 1.0
    lam: float = 1.5
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=True, init=False)

    @property
    def r_cut(self) -> float:
        return self.lam * self.diameter

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        well = torch.tensor(-self.epsilon, dtype=r2.dtype, device=r2.device)
        return torch.where(r2 <= self.r_cut * self.r_cut, well, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return r2 < self.diameter * self.diameter


@dataclasses.dataclass(frozen=True)
class Yukawa:
    """Screened-Coulomb repulsion eps (sigma/r) exp(-kappa (r - sigma)),
    truncated at r_cut: f32(eps sigma) / r, a true division as XLA's,
    times exp(f32(-kappa) (r - sigma))."""

    epsilon: float = 1.0
    sigma: float = 1.0
    kappa: float = 2.0
    r_cut: float = 3.0
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        amp = torch.full_like(r, self.epsilon * self.sigma) / r
        e = amp * torch.exp(-self.kappa * (r - self.sigma))
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)


@dataclasses.dataclass(frozen=True)
class Morse:
    """Morse eps ((1 - e^{-a(r - r0)})^2 - 1), truncated at r_cut and, if
    ``shift``, shifted to zero there by the float64 value the JAX package
    rounds."""

    epsilon: float = 1.0
    r0: float = 1.0
    a: float = 5.0
    r_cut: float = 2.5
    shift: bool = True
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)

    @property
    def shift_value(self) -> float:
        """eps (x_c^2 - 1) at the cutoff (0 when unshifted)."""
        if not self.shift:
            return 0.0
        xc = 1.0 - math.exp(-self.a * (self.r_cut - self.r0))
        return self.epsilon * (xc * xc - 1.0)

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        x = 1.0 - torch.exp(-self.a * (r - self.r0))
        e = self.epsilon * (x * x - 1.0)
        if self.shift:
            e = e - self.shift_value
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)


@dataclasses.dataclass(frozen=True)
class PolynomialPotential:
    """A pair potential as a polynomial in u = 1/r2: e = sum_k coeffs[k]
    u^k for r <= r_cut, with an optional hard core below
    ``core_diameter``; built by ``fit_pair_polynomial``. In float32 each
    Horner step is one fma, fma(e, u, f32(c_k)), as XLA contracts it."""

    coeffs: tuple = (0.0,)
    r_cut: float = 2.5
    core_diameter: float = 0.0
    has_energy: bool = dataclasses.field(default=True, init=False)

    def __post_init__(self):
        object.__setattr__(self, "coeffs",
                           tuple(float(c) for c in self.coeffs))

    @property
    def has_hard_core(self) -> bool:
        return self.core_diameter > 0.0

    def pair_energy(self, r2: torch.Tensor) -> torch.Tensor:
        u = safe_inv(r2)
        e = torch.full_like(r2, self.coeffs[-1])
        for c in reversed(self.coeffs[:-1]):
            e = fma_f32(e, u, c) if r2.dtype == torch.float32 else e * u + c
        return torch.where(r2 <= self.r_cut * self.r_cut, e, 0.0)

    def overlap(self, r2: torch.Tensor) -> torch.Tensor:
        if self.core_diameter <= 0.0:
            return torch.zeros(r2.shape, dtype=torch.bool, device=r2.device)
        return r2 < self.core_diameter * self.core_diameter


def fit_pair_polynomial(r, e, degree: int = 8, r_cut: float | None = None,
                        core_diameter: float = 0.0) -> PolynomialPotential:
    """Least-squares fit of a sampled pair potential e(r) to a polynomial
    in u = 1/r2 pinned to zero at the cutoff (the JAX package's
    ``fit_pair_polynomial``, the same numpy arithmetic, so the same
    coefficients). Raises if the residual is worse than 1e-3 of the
    sampled energy scale. Samples inside ``core_diameter`` are left out."""
    r = np.asarray(r, dtype=np.float64).reshape(-1)
    e = np.asarray(e, dtype=np.float64).reshape(-1)
    if r.shape != e.shape or r.size < degree + 1:
        raise ValueError("need matching r/e samples, more than degree+1")
    if r_cut is None:
        r_cut = float(r.max())
    keep = (r > core_diameter) & (r <= r_cut)
    if keep.sum() < degree + 1:
        raise ValueError("too few samples inside (core, r_cut]")
    u = 1.0 / (r[keep] ** 2)
    uc = 1.0 / (r_cut * r_cut)
    av = np.stack([u**k - uc**k for k in range(1, degree + 1)], axis=1)
    sol, *_ = np.linalg.lstsq(av, e[keep], rcond=None)
    resid = av @ sol - e[keep]
    scale = max(float(np.abs(e[keep]).max()), 1e-12)
    if float(np.abs(resid).max()) > 1e-3 * scale:
        raise ValueError(
            f"polynomial fit residual {float(np.abs(resid).max()):.3g} "
            f"exceeds 1e-3 x energy scale {scale:.3g}; raise the degree, "
            f"add a hard core below the stiff region, or shrink r_cut")
    c0 = -float(np.sum(sol * uc ** np.arange(1, degree + 1)))
    return PolynomialPotential(coeffs=(c0, *map(float, sol)), r_cut=r_cut,
                               core_diameter=core_diameter)


def core_diameter(pot: Potential) -> float:
    """The hard core's diameter (0 for a model without one)."""
    if not pot.has_hard_core:
        return 0.0
    if isinstance(pot, PolynomialPotential):
        return pot.core_diameter
    return pot.diameter


def interaction_reach(pot: Potential) -> float:
    """The farthest distance at which a pair still counts: the energy's
    cutoff, or the hard core's diameter where that is larger (and the
    only one for a model without energy)."""
    return max(pot.r_cut if pot.has_energy else 0.0, core_diameter(pot))


POTENTIAL_REGISTRY: dict[str, type] = {c.__name__: c for c in (
    LennardJones, HardSphere, SoftSphere, WCA, SquareWell, Yukawa, Morse,
    PolynomialPotential)}


def potential_to_dict(pot: Potential) -> dict:
    """{"kind": class name, "params": constructor arguments}: the JAX
    package's checkpoint payload for a model, of either package."""
    params = {f.name: getattr(pot, f.name)
              for f in dataclasses.fields(pot) if f.init}
    return {"kind": type(pot).__name__, "params": params}


def potential_from_dict(d: dict) -> Potential:
    """The port's model from ``potential_to_dict``'s payload."""
    from mcjax_torch.models import mixtures  # registers the mixture kinds
    kinds = {**POTENTIAL_REGISTRY, **mixtures.MIXTURE_REGISTRY}
    try:
        cls = kinds[d["kind"]]
    except KeyError:
        raise ValueError(f"unknown potential kind {d.get('kind')!r}; "
                         f"known: {sorted(kinds)}") from None
    return cls(**d["params"])


def pair_interaction(pot: Potential, r2: torch.Tensor, valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked (energy, overlap) terms for an array of squared distances."""
    e = torch.where(valid, pot.pair_energy(r2), 0.0)
    ov = valid & pot.overlap(r2)
    return e, ov
