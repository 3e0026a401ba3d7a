"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    There is no silent fall-back: asking for (or defaulting to) CUDA on a
    machine without a usable card raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mcjax_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def check_tensors(device: torch.device,
                  want: dict[str, tuple[torch.Tensor, torch.dtype, tuple]]
                  ) -> None:
    """Raise unless every named tensor is on ``device``, contiguous, and of
    the wanted dtype and shape; ``want`` maps name -> (tensor, dtype,
    shape). Kernels take raw pointers, so this is their input check."""
    for name, (t, dtype, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
