"""External one-body fields (twin of ``mcjax.models.fields``).

Traps, gravity, hard slit walls and their compositions, evaluated at
PHYSICAL coordinates x = wrap(stored + origin): the grid shift re-expresses
stored coordinates in a drifting frame, and ``mcjax_torch.ops.extfield``
carries that frame's ``origin``.

Frozen, hashable dataclasses with the JAX package's constructor arguments.
Arithmetic is float32 in the JAX package's order, with the fused
multiply-adds XLA on the CPU forms where a product meets a sum (measured,
``tests/test_torch_sweep.py::test_contraction_sites_match_xla``). A
product that an add or subtract may still absorb is carried as a
``Term`` and rounded only when it is used elsewhere: XLA folds the first
operand that is a product (``a * b + c`` -> fma(a, b, c), ``a * b - c`` ->
fma(a, b, -c), ``c - a * b`` -> fma(-a, b, c)), and of two products it
folds the one that is not a species-scaled product, else the first. The
sub-step kernels (``csrc/field.cuh``) make the same fma at the same sites.
The one case this misses is a product XLA shares between two terms (a
``LinearField`` both bare and inside a ``SpeciesField`` of one composite):
XLA keeps the shared product rounded and folds the species one, so its
energy is fma(c_s, p, p) where the port's is fma(g, x, f32(c_s p)), at most
one float32 ulp apart (a move's dE at most two), a gap the port keeps and
``tests/test_torch_field.py::test_shared_linear_product_gap`` holds.

Species coupling (mixtures): ``energy_s(x, s)`` / ``forbidden_s(x, s)``
take the per-particle float species id ``s``; ``species_energy`` /
``species_forbidden`` prefer them, as the JAX package's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mcjax_torch.models.potentials import fma_f32


class Term(NamedTuple):
    """A field energy as the sub-step's arithmetic sees it: the product
    ``a * b`` not rounded yet (``b`` a tensor) or the value ``a`` (``b``
    None). ``species``: a species-scaled product (``SpeciesField``), which
    an add folds only when the other operand is no plain product."""

    a: torch.Tensor
    b: torch.Tensor | None = None
    species: bool = False

    def value(self) -> torch.Tensor:
        return self.a if self.b is None else self.a * self.b


def _fma(a, b, c):
    if c.dtype == torch.float64:
        return a * b + c
    return fma_f32(a, b, c)


def _pick(x: Term, y: Term) -> bool:
    """True when XLA folds x (not y) into the add or subtract of x and y."""
    if x.b is None:
        return False
    return y.b is None or not x.species or y.species


def add_terms(x: Term, y: Term) -> Term:
    """x + y with XLA's contraction (a float64 sum is not contracted)."""
    if _pick(x, y):
        return Term(_fma(x.a, x.b, y.value()))
    if y.b is not None:
        return Term(_fma(y.a, y.b, x.value()))
    return Term(x.a + y.a)


def sub_terms(x: Term, y: Term) -> Term:
    """x - y with XLA's contraction."""
    if _pick(x, y):
        return Term(_fma(x.a, x.b, -y.value()))
    if y.b is not None:
        return Term(_fma(-y.a, y.b, x.value()))
    return Term(x.a - y.a)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in the tensor's dtype (rounded once, as the JAX
    package's weakly typed scalars are)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def species_energy(field, x: torch.Tensor, s: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """field's one-body energy, species-resolved when both the field and
    the caller support it (the mixture sub-step's dispatch point)."""
    return energy_term(field, x, s).value()


def energy_term(field, x: torch.Tensor, s: torch.Tensor | None = None
                ) -> Term:
    """``species_energy`` as a ``Term``, for the sub-step's dE."""
    if s is not None and hasattr(field, "energy_s"):
        return field.energy_term_s(x, s)
    return field.energy_term(x)


def species_forbidden(field, x: torch.Tensor, s: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """field's forbidden-region indicator, species-resolved when possible."""
    if s is not None and hasattr(field, "forbidden_s"):
        return field.forbidden_s(x, s)
    return field.forbidden(x)


def _select_by_species(values: tuple, s: torch.Tensor) -> torch.Tensor:
    """sum_k values[k] * [s == k]: at most one term is nonzero, so every
    sum is exact."""
    out = torch.zeros_like(s)
    for k, v in enumerate(values):
        out = out + _const(v, s) * (s == float(k)).to(s.dtype)
    return out


def _as_tuple(v, dim: int) -> tuple:
    if isinstance(v, (int, float)):
        return (float(v),) * dim
    t = tuple(float(x) for x in v)
    if len(t) != dim:
        raise ValueError(f"expected {dim} per-axis values, got {len(t)}")
    return t


def _no_region(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)


@dataclass(frozen=True)
class HarmonicTrap:
    """u(x) = sum_a k_a (x_a - c_a)^2 / 2: an optical-trap / umbrella
    restraint. ``stiffness`` is a scalar or per-axis tuple; axes with
    stiffness 0 are unconfined. Per axis the term is (f32(0.5 k) d) d with
    d = x - f32(c); the first two terms meet in fma(f32(0.5 k0) d0, d0,
    t1), a third in fma(f32(0.5 k2) d2, d2, that)."""
    stiffness: float | tuple = 1.0
    center: tuple = ()
    dim: int = 2

    has_energy = True

    def __post_init__(self):
        object.__setattr__(self, "stiffness",
                           _as_tuple(self.stiffness, self.dim))
        c = self.center if self.center else (0.0,) * self.dim
        object.__setattr__(self, "center", _as_tuple(c, self.dim))

    def energy_term(self, x: torch.Tensor) -> Term:
        e = None
        for a in range(self.dim):
            d = x[a] - _const(self.center[a], x) if self.center[a] else x[a]
            t = Term(_const(0.5 * self.stiffness[a], x) * d, d)
            e = t if e is None else add_terms(e, t)
        return e

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """x: [dim, *bs] physical coordinates -> [*bs] one-body energy."""
        return self.energy_term(x).value()

    def forbidden(self, x: torch.Tensor) -> torch.Tensor:
        return _no_region(x)


@dataclass(frozen=True)
class LinearField:
    """u(x) = g * x_axis: gravity / a uniform drive along one axis.

    In a periodic box this energy jumps across the wrap; pair it with
    ``SlitWalls`` on the same axis (``CompositeField``) so that no
    particle crosses the boundary: the sedimentation setup. With g = 1
    the product is x itself (XLA drops the multiply by one)."""
    g: float = 1.0
    axis: int = 0

    has_energy = True

    def energy_term(self, x: torch.Tensor) -> Term:
        if self.g == 1.0:
            return Term(x[self.axis])
        return Term(_const(self.g, x), x[self.axis])

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return self.energy_term(x).value()

    def forbidden(self, x: torch.Tensor) -> torch.Tensor:
        return _no_region(x)


@dataclass(frozen=True)
class SlitWalls:
    """Hard walls at x_axis = lo and x_axis = hi: particle CENTERS outside
    [lo + diameter/2, hi - diameter/2] are forbidden (zero energy inside:
    a slit pore). A start must already satisfy the constraint.

    ``diameters`` (optional per-species tuple) overrides ``diameter`` for
    mixture runs. The single-species bounds are the Python doubles
    lo + h, hi - h rounded once to float32; the per-species ones are
    f32(lo) + h and f32(hi) - h summed in float32 (``bounds``)."""
    lo: float
    hi: float
    axis: int = 0
    diameter: float = 0.0
    diameters: tuple = ()

    has_energy = False

    def __post_init__(self):
        object.__setattr__(self, "diameters",
                           tuple(float(d) for d in self.diameters))

    def energy_term(self, x: torch.Tensor) -> Term:
        return Term(torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return self.energy_term(x).value()

    def bounds(self, like: torch.Tensor, s: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(lower, upper) bound of the allowed centers, float32 as the
        comparisons use them: scalars, or per particle of species ``s``
        when ``diameters`` is set."""
        if s is None or not self.diameters:
            h = 0.5 * self.diameter
            return (_const(self.lo + h, like), _const(self.hi - h, like))
        h = 0.5 * _select_by_species(self.diameters, s)
        return _const(self.lo, s) + h, _const(self.hi, s) - h

    def forbidden(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds(x)
        return (x[self.axis] < lo) | (x[self.axis] > hi)

    def forbidden_s(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds(x, s)
        return (x[self.axis] < lo) | (x[self.axis] > hi)


@dataclass(frozen=True)
class SpeciesField:
    """Per-species coupling on a base field: u_k(x) = couplings[k] u(x)
    (gravity with per-species buoyant masses: sedimentation
    fractionation). Mixture runs only: the species-blind ``energy``
    raises."""
    base: object
    couplings: tuple

    def __post_init__(self):
        object.__setattr__(self, "couplings",
                           tuple(float(c) for c in self.couplings))
        if not self.base.has_energy:
            raise ValueError("SpeciesField scales an energy; base field "
                             "has none (walls: use SlitWalls.diameters)")

    has_energy = True

    def energy_term(self, x: torch.Tensor) -> Term:
        raise TypeError("SpeciesField is species-resolved; run it through "
                        "the mixture engine (ops/extfield.py with a mixture "
                        "potential)")

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return self.energy_term(x).value()

    def energy_term_s(self, x: torch.Tensor, s: torch.Tensor) -> Term:
        return Term(_select_by_species(self.couplings, s),
                    self.base.energy_term(x).value(), species=True)

    def energy_s(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return self.energy_term_s(x, s).value()

    def forbidden(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.forbidden(x)

    def forbidden_s(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return species_forbidden(self.base, x, s)


@dataclass(frozen=True)
class CompositeField:
    """Sum of fields: energies add in order, forbidden regions union
    (gravity + walls = sedimentation)."""
    fields: tuple

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def has_energy(self) -> bool:
        return any(f.has_energy for f in self.fields)

    def _sum(self, x: torch.Tensor, terms) -> Term:
        e = None
        for t in terms:
            e = t if e is None else add_terms(e, t)
        if e is None:
            return Term(torch.zeros(x.shape[1:], dtype=x.dtype,
                                    device=x.device))
        return e

    def energy_term(self, x: torch.Tensor) -> Term:
        return self._sum(x, (f.energy_term(x) for f in self.fields
                             if f.has_energy))

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        return self.energy_term(x).value()

    def energy_term_s(self, x: torch.Tensor, s: torch.Tensor) -> Term:
        return self._sum(x, (energy_term(f, x, s) for f in self.fields
                             if f.has_energy))

    def energy_s(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return self.energy_term_s(x, s).value()

    def forbidden(self, x: torch.Tensor) -> torch.Tensor:
        bad = _no_region(x)
        for f in self.fields:
            bad = bad | f.forbidden(x)
        return bad

    def forbidden_s(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        bad = _no_region(x)
        for f in self.fields:
            bad = bad | species_forbidden(f, x, s)
        return bad


def field_delta(field, de: torch.Tensor | None, x_new: torch.Tensor,
                x_old: torch.Tensor, s: torch.Tensor | None = None
                ) -> torch.Tensor:
    """A move's dE with the field's term, as the JAX package's sub-steps
    compute it (XLA's contractions included): single-species
    (de + E(new)) - E(old) (``mcjax/ops/sweep.py:209-215``), species-
    resolved (``s`` given) de + (E_s(new) - E_s(old))
    (``mcjax/ops/mixture.py:146-153``). ``de`` None is a pair model without
    energy, whose zero XLA folds away: E(new) - E(old)."""
    e_new = energy_term(field, x_new, s)
    e_old = energy_term(field, x_old, s)
    if de is None:
        return sub_terms(e_new, e_old).value()
    if s is not None:
        return de + sub_terms(e_new, e_old).value()
    return sub_terms(add_terms(Term(de), e_new), e_old).value()
