"""Color sub-step: plain PyTorch version and the wrapper of its CUDA kernel.

The kernel (``csrc/substep.cu``) replaces the move chain of the TPU kernels
``mcjax/ops/pallas_ring.py::ring_sweep_onecall`` (body
``mcjax/ops/pallas_sweep.py::_make_kernel``) in its 2D, hard-core,
host-random form: one thread owns one cell of the active color and makes
its n_moves moves against the frozen neighbor cells.

``color_substep`` below is the plain version, a twin of the hard-core branch
of ``mcjax.ops.sweep.color_substep``. ``substep`` is the wrapper the sweep
calls: on a CPU tensor it runs the plain version, on a CUDA tensor it
launches the kernel (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from mcjax_torch._build import CudaLibrary
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import check_tensors
from mcjax_torch.models.potentials import Potential, pair_interaction
from mcjax_torch.ops import cells

# Largest cell capacity the kernel is instantiated for (csrc/substep.cu).
KERNEL_NMAX = 16

LIB = CudaLibrary("substep", {
    "mcjax_substep_2d": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p],
})


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c rounded once to float32 (computed in float64, then rounded).

    XLA on the CPU contracts a multiply feeding an add into one fused
    multiply-add at two sites of the sub-step: the squared distance and the
    cell lower bound. The product of two f32 values is exact in f64, so this
    equals a true fma except where the f64 sum rounds onto an f32 rounding
    midpoint (double rounding), which no test has met.
    """
    return (a.double() * b.double() + c.double()).float()


def squared_norm(d: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_k d_k^2 over ``axis`` as XLA-CPU computes ``jnp.sum(d*d, axis)``:
    fma(d_1, d_1, d_0*d_0) in 2D (measured); 3D continues the chain with
    fma(d_2, d_2, ...), which no test has checked yet."""
    parts = d.unbind(axis)
    r2 = parts[0] * parts[0]
    for dk in parts[1:]:
        r2 = fma_f32(dk, dk, r2)
    return r2


def cell_lower_bounds(cfg: SimConfig, color: int, bs: tuple[int, ...],
                      device: torch.device) -> torch.Tensor:
    """Lower corner of every active cell of ``color``, [dim, *bs]:
    fma(c_k, w, -L/2) in float32, as XLA-CPU computes it."""
    o = cells.color_bits(color, cfg.dim)
    w = torch.tensor(cfg.cell_width, dtype=torch.float32, device=device)
    neg_half = torch.tensor(-cfg.box_length / 2.0, dtype=torch.float32,
                            device=device)
    lbs = []
    for k in range(cfg.dim):
        ck = 2 * cells.block_index(bs, k, device) + o[k]
        lbs.append(fma_f32(ck.to(torch.float32), w, neg_half))
    return torch.stack(lbs, dim=0)


def color_substep(cfg: SimConfig, pot: Potential, color: int,
                  pos: torch.Tensor, occ: torch.Tensor, pick_u: torch.Tensor,
                  disp: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_moves Metropolis moves in every cell of one color (plain version).

    Hard-core models only. Each move picks slot p = min(floor(u*occ),
    max(occ-1, 0)), proposes new = old + disp, and is accepted if the cell is
    non-empty, new stays inside the cell [lb, lb + w) on every axis, and new
    overlaps no valid slot of its own cell (other than itself) or of the 8
    (26 in 3D) frozen neighbor cells.

    Returns (new own-color block [dim, nmax, *bs], accepted, proposed); the
    counts are 0-d int64 tensors.
    """
    if pot.has_energy:
        raise NotImplementedError("only hard-core potentials are ported")
    nmax, n_m = cfg.nmax, cfg.n_moves
    dev = pos.device
    ownp = pos[color]                                  # [dim, nmax, *bs]
    own_occ = occ[color]                               # [*bs]
    bs = tuple(own_occ.shape)
    nbrp, nbr_occ = cells.neighbor_stack(cfg, pos, occ, color)
    lbp = cell_lower_bounds(cfg, color, bs, dev)       # [dim, *bs]
    hip = lbp + cfg.cell_width

    slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * len(bs))
    nbr_valid = slot[None] < nbr_occ[:, None]          # [K, nmax, *bs]
    own_valid = slot < own_occ[None]                   # [nmax, *bs]
    nonempty = own_occ > 0
    occ_f = own_occ.to(torch.float32)
    p_max = torch.clamp(own_occ - 1, min=0)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)

    for m in range(n_m):
        p = torch.floor(pick_u[m] * occ_f).to(torch.int64)
        p = torch.minimum(p, p_max)
        sel = slot == p[None]                          # [nmax, *bs]
        idx = p[None, None].expand((ownp.shape[0], 1) + bs)
        old = torch.gather(ownp, 1, idx).squeeze(1)    # [dim, *bs]
        new = old + disp[m]
        oob = ((new < lbp) | (new >= hip)).any(dim=0)

        r2_own = squared_norm(new[:, None] - ownp, 0)              # [nmax, *bs]
        _, ov_o = pair_interaction(pot, r2_own, own_valid & ~sel)
        r2_nbr = squared_norm(new[None, :, None] - nbrp, 1)        # [K, nmax, *bs]
        _, ov_n = pair_interaction(pot, r2_nbr, nbr_valid)
        ov = ov_o.any(dim=0) | ov_n.any(dim=1).any(dim=0)

        accept = nonempty & ~oob & ~ov
        ownp = torch.where((accept[None] & sel)[None], new[:, None], ownp)
        n_acc = n_acc + accept.sum()
    n_prop = n_m * nonempty.sum()
    return ownp, n_acc, n_prop


def substep(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
            occ: torch.Tensor, perm: torch.Tensor, i: int,
            pick_u: torch.Tensor, disp: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sub-step i of a sweep: color perm[i]; updates ``pos`` IN PLACE.

    In place is safe: a sub-step writes only its own color block and reads
    the others, and checkerboard neighbors are always other colors. Returns
    (accepted, proposed) as 0-d int64 tensors on pos's device. On a CPU
    tensor this runs the plain version; on a CUDA tensor it launches the
    kernel, reading the color from device memory (no host sync).
    """
    bs = cfg.block_shape
    want = {
        "pos": (pos, torch.float32, (cfg.n_colors, cfg.dim, cfg.nmax, *bs)),
        "occ": (occ, torch.int32, (cfg.n_colors, *bs)),
        "perm": (perm, torch.int32, (cfg.n_colors,)),
        "pick_u": (pick_u, torch.float32, (cfg.n_moves, *bs)),
        "disp": (disp, torch.float32, (cfg.n_moves, cfg.dim, *bs)),
    }
    check_tensors(pos.device, want)
    if pos.device.type == "cpu":
        color = int(perm[i])
        own_new, acc, prop = color_substep(cfg, pot, color, pos, occ, pick_u,
                                           disp)
        pos[color] = own_new
        return acc, prop
    if pos.device.type != "cuda":
        raise ValueError(f"no sub-step for device {pos.device}")
    if cfg.dim != 2 or pot.has_energy or not pot.has_hard_core:
        raise NotImplementedError(
            "the CUDA sub-step covers 2D hard disks only")
    if cfg.nmax > KERNEL_NMAX:
        raise NotImplementedError(
            f"the CUDA sub-step is built for nmax <= {KERNEL_NMAX}")
    if not 0 <= i < cfg.n_colors:
        raise ValueError(f"sub-step index {i} outside [0, {cfg.n_colors})")
    acc_map = torch.empty(cfg.block_shape, dtype=torch.int32,
                          device=pos.device)
    launch_kernel(cfg, pot, pos, occ, perm, i, pick_u, disp, acc_map)
    color_occ = occ.index_select(0, perm[i:i + 1])
    proposed = cfg.n_moves * (color_occ > 0).sum()
    return acc_map.sum(dtype=torch.int64), proposed


def launch_kernel(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                  occ: torch.Tensor, perm: torch.Tensor, i: int,
                  pick_u: torch.Tensor, disp: torch.Tensor,
                  acc_map: torch.Tensor) -> None:
    """One launch of the sub-step kernel on inputs ``substep`` has checked:
    updates pos[perm[i]] in place and writes the per-cell accept counts
    into ``acc_map`` (int32 [*bs])."""
    h, w = cfg.block_shape
    LIB.launch(
        "mcjax_substep_2d",
        pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), i,
        pick_u.data_ptr(), disp.data_ptr(), acc_map.data_ptr(),
        h, w, cfg.nmax, cfg.n_moves,
        cfg.cell_width, cfg.box_length / 2.0, cfg.box_length,
        pot.diameter * pot.diameter,
        torch.cuda.current_stream(pos.device).cuda_stream)
