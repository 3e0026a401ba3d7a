"""O(N^2) energy oracle (twin of ``mcjax.models.reference``'s
``total_energy`` and ``particle_energy``).

Every pair under the minimum image, with no cell list: the anchor that the
cell-list totals and a run's summed dE are held against at small N. Give it
float64 positions for a float64 total.
"""

from __future__ import annotations

import torch

from mcjax_torch.core.geometry import min_image
from mcjax_torch.models.potentials import Potential, pair_interaction


def total_energy(pot: Potential, positions: torch.Tensor, box_length: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(total energy, any overlap) of ``positions`` [N, dim] over every
    pair i < j."""
    disp = min_image(positions[:, None, :] - positions[None, :, :],
                     box_length)
    r2 = (disp * disp).sum(dim=-1)
    i, j = torch.triu_indices(positions.shape[0], positions.shape[0], 1,
                              device=positions.device)
    e, ov = pair_interaction(pot, r2[i, j],
                             torch.ones(i.shape, dtype=torch.bool,
                                        device=positions.device))
    return e.sum(), ov.any()


def particle_energy(pot: Potential, x: torch.Tensor, positions: torch.Tensor,
                    self_idx: int, box_length: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(energy, any overlap) of a particle at ``x`` [dim] against every
    particle of ``positions`` [N, dim] but ``self_idx``."""
    disp = min_image(x[None, :] - positions, box_length)
    r2 = (disp * disp).sum(dim=-1)
    valid = torch.arange(positions.shape[0], device=positions.device) \
        != self_idx
    e, ov = pair_interaction(pot, r2, valid)
    return e.sum(), ov.any()
