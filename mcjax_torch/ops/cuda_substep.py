"""Color sub-step: plain PyTorch version and the wrappers of its CUDA kernels.

Two kernels compute one color sub-step on the card; ``substep`` picks one by
(dim, model) and raises for any other configuration:

* ``csrc/substep.cu``, 2D hard disks: one thread owns one cell. It stands
  for ``mcjax/ops/pallas_ring.py::ring_sweep_onecall`` and the 2D form of
  ``ring_color_substep`` (body ``mcjax/ops/pallas_sweep.py::_make_kernel``),
  host-random form.
* ``csrc/substep_lj.cu``, 3D Lennard-Jones: one warp owns one cell, with the
  frozen-neighbor energy cache. It stands for
  ``mcjax/ops/pallas_sweep.py::_fused_core``, the single-species energetic
  form of ``pallas_color_substep`` and the 3D energetic form of
  ``ring_color_substep``, host-random form.

``color_substep`` below is the plain version, a twin of
``mcjax.ops.sweep.color_substep`` (hard-core and energetic branches). On a
CPU tensor ``substep`` runs it; on a CUDA tensor it launches a kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mcjax_torch._build import CudaLibrary
from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.device import check_tensors
from mcjax_torch.models.potentials import (HardSphere, LennardJones, Potential,
                                           fma_f32, pair_interaction)
from mcjax_torch.ops import cells

# Largest cell capacity each kernel is instantiated for: the disk kernel
# keeps a cell in a thread's registers, the LJ kernel one slot per lane.
KERNEL_NMAX = 16
KERNEL_NMAX_LJ = 32

LIB = CudaLibrary("substep", {
    "mcjax_substep_2d": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p],
})

LIB_LJ = CudaLibrary("substep_lj", {
    "mcjax_substep_lj3d": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p],
})


def squared_norm(d: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_k d_k^2 over ``axis`` as XLA-CPU computes ``jnp.sum(d*d, axis)``:
    a chain of fused multiply-adds, fma(d_1, d_1, d_0*d_0) in 2D and
    fma(d_2, d_2, fma(d_1, d_1, d_0*d_0)) in 3D (both measured,
    ``test_contraction_sites_match_xla``)."""
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
                  disp: torch.Tensor, acc_u: torch.Tensor | None = None,
                  record: dict | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """n_moves Metropolis moves in every cell of one color (plain version).

    Each move picks slot p = min(floor(u*occ), max(occ-1, 0)), proposes
    new = old + disp and rejects it if the cell is empty or new leaves the
    cell [lb, lb + w) on any axis. Hard-core models then reject an overlap
    with a valid slot of the own cell (other than p) or of the 8 (26 in 3D)
    frozen neighbor cells. Energetic models sum the pair energy e(x) of the
    mover over the same slots at old and new and accept when
    acc_u < exp(-beta (e(new) - e(old))); ``acc_u`` [n_moves, *bs] is then
    required.

    ``record``, if given, receives per-cell maps over [*bs]: ``de_cell``
    (the summed dE of accepted moves), ``in_cell`` (moves of a non-empty
    cell that stayed inside it, the ones that need pair work) and, for
    energetic models, ``margin`` (the smallest |acc_u - a| / a over those
    moves, a = exp(-beta dE): how close a decision came to a tie).

    Returns (new own-color block [dim, nmax, *bs], dE, accepted, proposed):
    dE is a 0-d float32 tensor (0 for hard-core models), the counts 0-d
    int64 tensors.
    """
    energetic = pot.has_energy
    if energetic and acc_u is None:
        raise ValueError("an energetic model needs acceptance uniforms")
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
    de_sum = torch.zeros((), dtype=torch.float32, device=dev)
    de_cell = torch.zeros(bs, dtype=torch.float32, device=dev)
    in_cell = torch.zeros(bs, dtype=torch.int32, device=dev)
    margin = torch.full(bs, float("inf"), dtype=torch.float32, device=dev)

    def energy_at(x, valid_own):
        """(energy, overlap) of a mover at x [dim, *bs] against its own
        cell's valid slots and the frozen neighbor slots."""
        r2_own = squared_norm(x[:, None] - ownp, 0)              # [nmax, *bs]
        e_o, ov_o = pair_interaction(pot, r2_own, valid_own)
        r2_nbr = squared_norm(x[None, :, None] - nbrp, 1)        # [K, nmax, *bs]
        e_n, ov_n = pair_interaction(pot, r2_nbr, nbr_valid)
        ov = ov_o.any(dim=0) | ov_n.any(dim=1).any(dim=0)
        if not energetic:
            return None, ov
        return e_o.sum(dim=0) + e_n.sum(dim=(0, 1)), ov

    for m in range(n_m):
        p = torch.floor(pick_u[m] * occ_f).to(torch.int64)
        p = torch.minimum(p, p_max)
        sel = slot == p[None]                          # [nmax, *bs]
        idx = p[None, None].expand((ownp.shape[0], 1) + bs)
        old = torch.gather(ownp, 1, idx).squeeze(1)    # [dim, *bs]
        new = old + disp[m]
        oob = ((new < lbp) | (new >= hip)).any(dim=0)
        valid_own = own_valid & ~sel

        e_new, ov = energy_at(new, valid_own)
        live = nonempty & ~oob
        accept = live & ~ov
        if energetic:
            e_old, _ = energy_at(old, valid_own)
            de = e_new - e_old
            a = torch.exp(-cfg.beta * de)
            accept = accept & (acc_u[m] < a)
            de_acc = torch.where(accept, de, 0.0)
            de_sum = de_sum + de_acc.sum()
            de_cell = de_cell + de_acc
            rel = (acc_u[m] - a).abs() / a
            margin = torch.where(live, torch.fmin(margin, rel), margin)
        ownp = torch.where((accept[None] & sel)[None], new[:, None], ownp)
        n_acc = n_acc + accept.sum()
        in_cell = in_cell + live.to(torch.int32)
    n_prop = n_m * nonempty.sum()
    if record is not None:
        record.update(de_cell=de_cell, in_cell=in_cell)
        if energetic:
            record["margin"] = margin
    return ownp, de_sum, n_acc, n_prop


def kernel_library(cfg: SimConfig, pot: Potential) -> CudaLibrary:
    """The CUDA library whose kernel runs this configuration's sub-step;
    raises NotImplementedError for one no kernel covers."""
    if cfg.dim == 2 and isinstance(pot, HardSphere):
        if cfg.nmax > KERNEL_NMAX:
            raise NotImplementedError(
                f"the 2D disk sub-step kernel is built for nmax <= "
                f"{KERNEL_NMAX}")
        return LIB
    if cfg.dim == 3 and isinstance(pot, LennardJones):
        if cfg.nmax > KERNEL_NMAX_LJ:
            raise NotImplementedError(
                f"the 3D LJ sub-step kernel is built for nmax <= "
                f"{KERNEL_NMAX_LJ}")
        return LIB_LJ
    raise NotImplementedError(
        f"no CUDA sub-step kernel for a {cfg.dim}D {type(pot).__name__} "
        "model: the kernels cover 2D hard disks and 3D Lennard-Jones")


def substep(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
            occ: torch.Tensor, perm: torch.Tensor, i: int,
            pick_u: torch.Tensor, disp: torch.Tensor,
            acc_u: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sub-step i of a sweep: color perm[i]; updates ``pos`` IN PLACE.

    In place is safe: a sub-step writes only its own color block and reads
    the others, and checkerboard neighbors are always other colors. Returns
    (dE, accepted, proposed) as 0-d tensors (float32, int64, int64) on pos's
    device; energetic models need ``acc_u``. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the kernel, reading the
    color from device memory (no host sync).
    """
    bs = cfg.block_shape
    want = {
        "pos": (pos, torch.float32, (cfg.n_colors, cfg.dim, cfg.nmax, *bs)),
        "occ": (occ, torch.int32, (cfg.n_colors, *bs)),
        "perm": (perm, torch.int32, (cfg.n_colors,)),
        "pick_u": (pick_u, torch.float32, (cfg.n_moves, *bs)),
        "disp": (disp, torch.float32, (cfg.n_moves, cfg.dim, *bs)),
    }
    if pot.has_energy:
        if acc_u is None:
            raise ValueError("an energetic model needs acceptance uniforms")
        want["acc_u"] = (acc_u, torch.float32, (cfg.n_moves, *bs))
    check_tensors(pos.device, want)
    if not 0 <= i < cfg.n_colors:
        raise ValueError(f"sub-step index {i} outside [0, {cfg.n_colors})")
    if pos.device.type == "cpu":
        color = int(perm[i])
        own_new, de, acc, prop = color_substep(cfg, pot, color, pos, occ,
                                               pick_u, disp, acc_u)
        pos[color] = own_new
        return de, acc, prop
    lib = kernel_library(cfg, pot)
    if pos.device.type != "cuda":
        raise ValueError(f"no sub-step for device {pos.device}")
    acc_map = torch.empty(bs, dtype=torch.int32, device=pos.device)
    if lib is LIB_LJ:
        de_map = torch.empty(bs, dtype=torch.float32, device=pos.device)
        launch_lj_kernel(cfg, pot, pos, occ, perm, i, pick_u, disp, acc_u,
                         de_map, acc_map)
        de = de_map.sum()
    else:
        launch_kernel(cfg, pot, pos, occ, perm, i, pick_u, disp, acc_map)
        de = torch.zeros((), dtype=torch.float32, device=pos.device)
    color_occ = occ.index_select(0, perm[i:i + 1])
    proposed = cfg.n_moves * (color_occ > 0).sum()
    return de, acc_map.sum(dtype=torch.int64), proposed


def launch_kernel(cfg: SimConfig, pot: Potential, pos: torch.Tensor,
                  occ: torch.Tensor, perm: torch.Tensor, i: int,
                  pick_u: torch.Tensor, disp: torch.Tensor,
                  acc_map: torch.Tensor) -> None:
    """One launch of the 2D disk kernel on inputs ``substep`` has checked:
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


def launch_lj_kernel(cfg: SimConfig, pot: LennardJones, pos: torch.Tensor,
                     occ: torch.Tensor, perm: torch.Tensor, i: int,
                     pick_u: torch.Tensor, disp: torch.Tensor,
                     acc_u: torch.Tensor, de_map: torch.Tensor,
                     acc_map: torch.Tensor) -> None:
    """One launch of the 3D LJ kernel on inputs ``substep`` has checked:
    updates pos[perm[i]] in place and writes each cell's summed dE of
    accepted moves into ``de_map`` (float32 [*bs]) and its accept count into
    ``acc_map`` (int32 [*bs]). The model's constants go in as the float32
    values the plain version rounds them to."""
    LIB_LJ.launch(
        "mcjax_substep_lj3d",
        pos.data_ptr(), occ.data_ptr(), perm.data_ptr(), i,
        pick_u.data_ptr(), disp.data_ptr(), acc_u.data_ptr(),
        de_map.data_ptr(), acc_map.data_ptr(),
        cfg.half_cps, cfg.nmax, cfg.n_moves,
        cfg.cell_width, cfg.box_length / 2.0, cfg.box_length, cfg.beta,
        pot.sigma * pot.sigma, 4.0 * pot.epsilon, pot.shift_value,
        pot.r_cut * pot.r_cut,
        torch.cuda.current_stream(pos.device).cuda_stream)
