"""Static simulation configuration (copy of ``mcjax.core.config``).

The port keeps its own copy: importing ``mcjax.core.config`` would run
``mcjax/__init__.py``, which imports jax. Fields, validation and derived
geometry are identical to the JAX package's ``SimConfig``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Geometry + schedule of a checkerboard-decomposed Metropolis MC run.

    ``n_atoms`` particles in a periodic box of side ``box_length`` cut into
    ``cells_per_side``^dim cells of capacity ``nmax``; each sweep makes
    ``n_moves`` trial moves per cell of every color, then one grid shift
    every ``shift_every`` sweeps.
    """

    dim: int = 3
    n_atoms: int = 800
    box_length: float = 10.0
    cells_per_side: int = 4
    nmax: int = 30
    n_moves: int = 15
    proposal: str = "gaussian"  # "gaussian" or "uniform"
    step_size: float = 0.5
    beta: float = 0.3
    sweeps: int = 1000
    shift_every: int = 1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.cells_per_side % 2 != 0 or self.cells_per_side < 4:
            # The 2^dim-color checkerboard needs an even grid; cps>=4 keeps a
            # cell out of its own 3^dim neighborhood under PBC.
            raise ValueError(
                f"cells_per_side must be even and >= 4, got {self.cells_per_side}"
            )
        if self.proposal not in ("gaussian", "uniform"):
            raise ValueError(f"unknown proposal {self.proposal!r}")
        if self.nmax < 1:
            raise ValueError("nmax must be >= 1")

    # ---- derived geometry -------------------------------------------------

    @property
    def cell_width(self) -> float:
        """w = L / cells_per_side; must be >= the potential cutoff."""
        return self.box_length / self.cells_per_side

    @property
    def n_cells(self) -> int:
        return self.cells_per_side**self.dim

    @property
    def n_colors(self) -> int:
        """2^dim checkerboard parity classes."""
        return 2**self.dim

    @property
    def half_cps(self) -> int:
        """Cells per side of one color block."""
        return self.cells_per_side // 2

    @property
    def cells_per_color(self) -> int:
        return self.half_cps**self.dim

    @property
    def block_shape(self) -> tuple[int, ...]:
        """Spatial shape of one color block: (half_cps,) * dim."""
        return (self.half_cps,) * self.dim

    @property
    def n_neighbors(self) -> int:
        """Size of the 3^dim cell neighborhood."""
        return 3**self.dim

    def validate_against(self, r_cut: float) -> None:
        if self.cell_width + 1e-6 < r_cut:
            raise ValueError(
                f"cell_width {self.cell_width} < potential cutoff {r_cut}; "
                "the one-ring neighborhood would miss interactions"
            )

    def replace(self, **kwargs: Any) -> "SimConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def auto_nmax(dim: int, n_atoms: int, box_length: float, cells_per_side: int,
                  safety: float = 3.0, minimum: int = 4) -> int:
        """Capacity heuristic: safety × mean occupancy, rounded up."""
        mean_occ = n_atoms / cells_per_side**dim
        return max(minimum, math.ceil(mean_occ * safety))
