"""Multi-species pair models (twin of ``mcjax.models.mixtures``).

A mixture evaluates its pair energy on (r2, s_i, s_j), where the species
operands are float tensors holding small integer ids: the id rides the
state as one extra plane after the coordinates (``mcjax_torch.ops.mixture``).
Ported so far: ``LJMixture`` and ``kob_andersen``. Every float32 operation
is the one XLA on the CPU performs for the JAX package's model, contractions
included, so energies match it bit for bit; float64 input is evaluated in
plain float64.

Parameter tables are nested tuples [S][S], symmetric, given as the JAX
package's constructor takes them, so one set of tuples builds both models.
"""

from __future__ import annotations

import dataclasses

import torch

from mcjax_torch.models.potentials import fma_f32, safe_inv


def _as_table(table) -> tuple:
    """Coerce a nested sequence to a nested tuple of floats."""
    return tuple(tuple(float(v) for v in row) for row in table)


def _sym(table) -> int:
    """Check that a nested-tuple [S][S] table is square and symmetric;
    return S."""
    s = len(table)
    for row in table:
        if len(row) != s:
            raise ValueError(f"species table must be square, got {table}")
    for a in range(s):
        for b in range(s):
            if table[a][b] != table[b][a]:
                raise ValueError(f"species table must be symmetric, "
                                 f"got {table}")
    return s


def _poly3(f0: float, f1: float, f2: float) -> tuple[float, float, float]:
    """Quadratic through (0, f0), (1, f1), (2, f2). In a binary mixture
    u = s_i + s_j in {0, 1, 2} names the unordered species pair, so every
    per-pair parameter is a quadratic in u."""
    return (f0, -1.5 * f0 + 2.0 * f1 - 0.5 * f2, 0.5 * f0 - f1 + 0.5 * f2)


def _blend(c: tuple[float, float, float], u: torch.Tensor,
           u2: torch.Tensor) -> torch.Tensor:
    """c0 + c1 u + c2 u^2. For u in {0, 1, 2} the products are exact, so
    a contracted and an uncontracted form give the same bits."""
    return c[0] + c[1] * u + c[2] * u2


def _pair_mask(si: torch.Tensor, sj: torch.Tensor, a: int, b: int
               ) -> torch.Tensor:
    m = (si == float(a)) & (sj == float(b))
    if a != b:
        m = m | ((si == float(b)) & (sj == float(a)))
    return m


def _float32(r2: torch.Tensor) -> bool:
    return r2.dtype == torch.float32


@dataclasses.dataclass(frozen=True)
class LJMixture:
    """Truncated LJ 12-6 with per-species-pair (epsilon, sigma, r_cut).

    ``epsilon``, ``sigma`` and ``r_cut_table`` are symmetric [S][S] nested
    tuples; ``shift=True`` subtracts each pair's cutoff value.
    """

    epsilon: tuple
    sigma: tuple
    r_cut_table: tuple
    shift: bool = True
    has_energy: bool = dataclasses.field(default=True, init=False)
    has_hard_core: bool = dataclasses.field(default=False, init=False)
    is_mixture: bool = dataclasses.field(default=True, init=False)

    def __post_init__(self):
        object.__setattr__(self, "epsilon", _as_table(self.epsilon))
        object.__setattr__(self, "sigma", _as_table(self.sigma))
        object.__setattr__(self, "r_cut_table", _as_table(self.r_cut_table))
        s = _sym(self.epsilon)
        if _sym(self.sigma) != s or _sym(self.r_cut_table) != s:
            raise ValueError("species tables disagree on S")

    @property
    def n_species(self) -> int:
        return len(self.epsilon)

    @property
    def r_cut(self) -> float:
        """Largest pair cutoff: what the cell width must cover."""
        return max(max(row) for row in self.r_cut_table)

    def _term(self, r2: torch.Tensor, eps: float, sig: float,
              rc: float) -> torch.Tensor:
        """One species pair's LJ term (as LennardJones.pair_energy, with
        the JAX package's division by r2: a tensor numerator, since
        ``scalar / tensor`` in PyTorch multiplies by a reciprocal)."""
        num = torch.tensor(sig * sig, dtype=r2.dtype, device=r2.device)
        inv2 = num / torch.clamp(r2, min=1e-12)
        inv6 = inv2 * inv2 * inv2
        s6 = (sig / rc) ** 6
        shift_c = 4.0 * eps * (s6 * s6 - s6) if self.shift else 0.0
        if _float32(r2):
            bracket = fma_f32(inv6, inv6, -inv6)
            e = (fma_f32(4.0 * eps, bracket, -shift_c) if self.shift
                 else (4.0 * eps) * bracket)
        else:
            e = 4.0 * eps * (inv6 * inv6 - inv6) - shift_c
        return torch.where(r2 <= rc * rc, e, 0.0)

    def _binary_coeffs(self):
        """Quadratic-in-(s_i + s_j) coefficients of (4 eps, sigma^2,
        r_cut^2, shift constant)."""
        def tab(t):
            return float(t[0][0]), float(t[0][1]), float(t[1][1])

        eps, sig, rc = tab(self.epsilon), tab(self.sigma), tab(self.r_cut_table)

        def sh(e, s, c):
            s6 = (s / c) ** 6
            return 4.0 * e * (s6 * s6 - s6)

        return (_poly3(*(4.0 * e for e in eps)),
                _poly3(*(s * s for s in sig)),
                _poly3(*(c * c for c in rc)),
                _poly3(*(sh(e, s, c) for e, s, c in zip(eps, sig, rc))))

    def _uniform_cutoff_ratio2(self) -> float | None:
        """(r_cut / sigma)^2 if that ratio is the same for every species
        pair (Kob-Andersen: 2.5^2), else None."""
        s = self.n_species
        ratios = [self.r_cut_table[a][b] / self.sigma[a][b]
                  for a in range(s) for b in range(s)]
        if max(ratios) - min(ratios) <= 1e-12 * max(ratios):
            return ratios[0] * ratios[0]
        return None

    @property
    def uniform_shift_constant(self) -> float:
        """ic6^2 - ic6 with ic6 = (sigma / r_cut)^6 of a species-independent
        cutoff ratio: what the shifted binary form subtracts from the LJ
        bracket (0 when unshifted). Requires that ratio."""
        c2 = self._uniform_cutoff_ratio2()
        if c2 is None:
            raise ValueError("the cutoff ratio depends on the species pair")
        if not self.shift:
            return 0.0
        ic6 = 1.0 / (c2 * c2 * c2)
        return ic6 * ic6 - ic6

    def _energy_binary(self, r2: torch.Tensor, si: torch.Tensor,
                       sj: torch.Tensor) -> torch.Tensor:
        """One LJ evaluation on u-blended per-pair coefficients (S == 2).

        With a species-independent cutoff ratio c the cutoff test is
        inv2 c^2 >= 1 and the shift a constant of the bracket. In float32,
        as XLA on the CPU computes it: inv = 1 / max(r2, 1e-12) correctly
        rounded, inv2 = blend(sigma^2) inv, inv6 = (inv2 inv2) inv2,
        poly = fma(inv6, inv6, -inv6) - f32(ic6^2 - ic6),
        e = blend(4 eps) poly.
        """
        ce4, cs2, crc2, csh = self._binary_coeffs()
        c2 = self._uniform_cutoff_ratio2()
        u = si + sj
        u2 = u * u
        inv = safe_inv(r2)
        inv2 = _blend(cs2, u, u2) * inv
        inv6 = inv2 * inv2 * inv2
        poly = (fma_f32(inv6, inv6, -inv6) if _float32(r2)
                else inv6 * inv6 - inv6)
        if c2 is not None:
            if self.shift:
                poly = poly - self.uniform_shift_constant
            e = _blend(ce4, u, u2) * poly
            return torch.where(inv2 * c2 >= 1.0, e, 0.0)
        if self.shift:
            if _float32(r2):
                e = fma_f32(_blend(ce4, u, u2), poly, -_blend(csh, u, u2))
            else:
                e = _blend(ce4, u, u2) * poly - _blend(csh, u, u2)
        else:
            e = _blend(ce4, u, u2) * poly
        return torch.where(r2 <= _blend(crc2, u, u2), e, 0.0)

    def _energy_masked(self, r2: torch.Tensor, si: torch.Tensor,
                       sj: torch.Tensor) -> torch.Tensor:
        shape = torch.broadcast_shapes(r2.shape, si.shape, sj.shape)
        e = torch.zeros(shape, dtype=r2.dtype, device=r2.device)
        s = self.n_species
        for a in range(s):
            for b in range(a, s):
                e = e + torch.where(
                    _pair_mask(si, sj, a, b),
                    self._term(r2, self.epsilon[a][b], self.sigma[a][b],
                               self.r_cut_table[a][b]),
                    0.0)
        return e

    def pair_energy_s(self, r2: torch.Tensor, si: torch.Tensor,
                      sj: torch.Tensor) -> torch.Tensor:
        """Pair energy at squared distance r2 between species si and sj."""
        if self.n_species == 2:
            return self._energy_binary(r2, si, sj)
        return self._energy_masked(r2, si, sj)

    @property
    def supports_mover_hoist(self) -> bool:
        """True for a binary mixture with a species-independent cutoff
        ratio (the Kob-Andersen convention): the form the CUDA mixture
        sub-step computes."""
        return (self.n_species == 2
                and self._uniform_cutoff_ratio2() is not None)

    def overlap_s(self, r2: torch.Tensor, si: torch.Tensor,
                  sj: torch.Tensor) -> torch.Tensor:
        shape = torch.broadcast_shapes(r2.shape, si.shape, sj.shape)
        return torch.zeros(shape, dtype=torch.bool, device=r2.device)


def kob_andersen(shift: bool = True) -> LJMixture:
    """The 80:20 binary LJ glass former (Kob and Andersen, PRE 51, 4626
    (1995)): eps AA/AB/BB = 1.0/1.5/0.5, sigma = 1.0/0.8/0.88,
    r_cut = 2.5 sigma per pair."""
    eps = ((1.0, 1.5), (1.5, 0.5))
    sig = ((1.0, 0.8), (0.8, 0.88))
    rc = tuple(tuple(2.5 * s for s in row) for row in sig)
    return LJMixture(epsilon=eps, sigma=sig, r_cut_table=rc, shift=shift)


# The mixture kinds of ``potentials.potential_from_dict`` (the JAX
# package's ``HardSphereMixture`` is not ported yet).
MIXTURE_REGISTRY: dict[str, type] = {"LJMixture": LJMixture}
