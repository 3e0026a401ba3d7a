"""Carry a state between the JAX package and the port as numpy arrays.

``state_from_numpy(np.asarray(s.pos), np.asarray(s.occ), s.sweep,
s.overflow)`` takes an ``mcjax`` SimState across; ``state_to_numpy`` gives
the same four arrays back. Both packages share the slab layout, so nothing
is reordered; a mixture state's species plane comes across as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.state import SimState


def state_from_numpy(pos, occ, sweep, overflow,
                     device: str | torch.device | None = None) -> SimState:
    """Build a SimState on ``device`` (CUDA unless named) from numpy data."""
    dev = resolve_device(device)
    pos = np.array(pos, dtype=np.float32)   # copies: the tensors own
    occ = np.array(occ, dtype=np.int32)     # their memory
    if pos.ndim < 4 or occ.shape != (pos.shape[0], *pos.shape[3:]):
        raise ValueError(f"pos {pos.shape} and occ {occ.shape} are not one "
                         "slab state")
    return SimState(
        pos=torch.from_numpy(pos).to(dev),
        occ=torch.from_numpy(occ).to(dev),
        sweep=int(np.asarray(sweep)),
        overflow=torch.tensor(bool(np.asarray(overflow)), device=dev),
    )


def state_to_numpy(state: SimState
                   ) -> tuple[np.ndarray, np.ndarray, np.int32, np.bool_]:
    """(pos, occ, sweep, overflow) as numpy values."""
    return (state.pos.cpu().numpy(), state.occ.cpu().numpy(),
            np.int32(state.sweep), np.bool_(bool(state.overflow)))
