"""Periodic-boundary geometry helpers (twin of ``mcjax.core.geometry``)."""

from __future__ import annotations

import torch


def min_image(disp: torch.Tensor, box_length: float) -> torch.Tensor:
    """Exact minimum-image displacement for a cubic box of side ``box_length``."""
    return disp - box_length * torch.round(disp / box_length)


def wrap_into_box(x: torch.Tensor, box_length: float) -> torch.Tensor:
    """Wrap coordinates into [-L/2, L/2).

    ``torch.remainder`` on floats is fmod plus a sign fix-up, the same
    operation ``jnp.mod`` lowers to, so the result is bitwise equal.
    """
    half = box_length / 2.0
    return torch.remainder(x + half, box_length) - half
