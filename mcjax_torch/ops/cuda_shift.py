"""Grid shift: the wrapper of its CUDA kernel, with the plain version.

The kernel (``csrc/shift.cu``, 2D and 3D) replaces the TPU kernels
``mcjax/ops/pallas_ring.py::ring_shift`` and
``mcjax/ops/pallas_shift.py::pallas_shift_rebin``: shift every coordinate on
one axis, re-bin, merge each cell's own slab with its donor neighbor's slab
in a fixed candidate order and compact to nmax. Its plain version is
``mcjax_torch.ops.cells.shift_rebin`` (imported here as ``shift_rebin``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mcjax_torch._build import CudaLibrary
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import check_tensors
from mcjax_torch.ops.cells import shift_rebin

LIB = CudaLibrary("shift", {
    "mcjax_shift": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p],
})

__all__ = ["LIB", "launch_kernel", "shift", "shift_rebin"]


def shift(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
          axis: torch.Tensor, d: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid shift along ``axis`` (int32 0-d) by ``d`` (float32 0-d).

    Returns (pos, occ, overflow) in new buffers; overflow is a 0-d bool
    tensor. On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel, which reads axis and d from device memory (no host
    sync).
    """
    bs = cfg.block_shape
    want = {
        "pos": (pos, torch.float32, (cfg.n_colors, cfg.dim, cfg.nmax, *bs)),
        "occ": (occ, torch.int32, (cfg.n_colors, *bs)),
        "axis": (axis, torch.int32, ()),
        "d": (d, torch.float32, ()),
    }
    check_tensors(pos.device, want)
    if pos.device.type == "cpu":
        return shift_rebin(cfg, pos, occ, axis, d)
    if pos.device.type != "cuda":
        raise ValueError(f"no grid shift for device {pos.device}")
    pos_out = torch.empty_like(pos)
    occ_out = torch.empty_like(occ)
    ovf = torch.zeros((), dtype=torch.int32, device=pos.device)
    launch_kernel(cfg, pos, occ, axis, d, pos_out, occ_out, ovf)
    return pos_out, occ_out, ovf != 0


def launch_kernel(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                  axis: torch.Tensor, d: torch.Tensor, pos_out: torch.Tensor,
                  occ_out: torch.Tensor, ovf: torch.Tensor) -> None:
    """One launch of the shift kernel on inputs ``shift`` has checked:
    writes pos_out and occ_out, and sets ``ovf`` (int32, zeroed by the
    caller) to 1 if a cell overflows."""
    LIB.launch(
        "mcjax_shift",
        pos.data_ptr(), occ.data_ptr(), pos_out.data_ptr(), occ_out.data_ptr(),
        ovf.data_ptr(), axis.data_ptr(), d.data_ptr(),
        cfg.dim, cfg.half_cps, cfg.nmax, cfg.cells_per_side,
        cfg.box_length, cfg.box_length / 2.0,
        float(np.float32(1.0 / cfg.cell_width)),
        torch.cuda.current_stream(pos.device).cuda_stream)
