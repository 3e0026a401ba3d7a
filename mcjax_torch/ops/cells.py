"""Cell-list machinery on color-blocked slabs (twin of ``mcjax.ops.cells``).

Plain PyTorch versions of the JAX package's binning, neighbor reads and grid
shift. Every floating-point operation is the one the JAX package performs,
in the same order, so states match it bit for bit on the CPU. The grid
shift's CUDA kernel lives in ``mcjax_torch.ops.cuda_shift`` and is held
against ``shift_rebin`` below.

Cell indexing: coordinate x_k in [-L/2, L/2); cell index
c_k = floor((x_k + L/2)/w); parity bit o_k = c_k & 1; block index b_k = c_k >> 1;
color id = sum_k o_k << k. State layout:

    pos[color, dim, nmax, b_0, ..., b_{dim-1}]     occ[color, b_0, ..., b_{dim-1}]
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.geometry import wrap_into_box


def roll_shift(block: torch.Tensor, shifts: tuple[int, ...]) -> torch.Tensor:
    """Read block at cell offset ``shifts``: out[b] = block[b + shifts] (PBC).

    The trailing len(shifts) axes of ``block`` are the cell grid.
    """
    dim = len(shifts)
    for ax, s in enumerate(shifts):
        if s:
            block = torch.roll(block, -s, dims=ax - dim)
    return block


def color_bits(color: int, dim: int) -> tuple[int, ...]:
    return tuple((color >> k) & 1 for k in range(dim))


def neighbor_offsets(dim: int, include_center: bool = False
                     ) -> list[tuple[int, ...]]:
    """The 3^dim cell offsets, lexicographic over (-1, 0, 1)^dim."""
    offs = list(itertools.product((-1, 0, 1), repeat=dim))
    if not include_center:
        offs = [o for o in offs if any(o)]
    return offs


def neighbor_plan(dim: int, color: int, include_center: bool = False
                  ) -> list[tuple[int, tuple[int, ...]]]:
    """For each neighbor offset of a color-``color`` cell: (source color,
    block shift).

    For active cell (o, b) and offset d: t_k = o_k + d_k; source color bit
    o'_k = t_k & 1; block shift s_k = t_k >> 1 (floor). Every non-zero offset
    lands in a different color, so neighbors are frozen during a sub-step.
    """
    o = color_bits(color, dim)
    plan = []
    for off in neighbor_offsets(dim, include_center):
        t = [o[k] + off[k] for k in range(dim)]
        src_color = sum((t[k] & 1) << k for k in range(dim))
        shifts = tuple(t[k] >> 1 for k in range(dim))
        plan.append((src_color, shifts))
    return plan


def block_index(bs: tuple[int, ...], axis: int, device: torch.device
                ) -> torch.Tensor:
    """Block index along ``axis`` at every cell of a [*bs] grid (an iota)."""
    shape = [1] * len(bs)
    shape[axis] = bs[axis]
    idx = torch.arange(bs[axis], dtype=torch.int32, device=device)
    return idx.reshape(shape).expand(bs)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def lattice_positions(cfg: SimConfig, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    """Uniform cubic/square lattice: r_k(i) = L/2 (1 - (2 i_k + 1)/m) with
    m = ceil(N^(1/dim)); computed in float64 on the host, rounded to f32."""
    m = int(np.ceil(cfg.n_atoms ** (1.0 / cfg.dim) - 1e-9))
    idx = np.arange(cfg.n_atoms)
    coords = []
    for k in range(cfg.dim):
        ik = (idx // m**k) % m
        coords.append(cfg.box_length / 2.0 * (1.0 - (2.0 * ik + 1.0) / m))
    return torch.as_tensor(np.stack(coords, axis=-1).astype(np.float32),
                           device=device)


def stratified_positions(cfg: SimConfig, device: torch.device | str = "cpu"
                         ) -> torch.Tensor:
    """Cell-stratified start: every cell gets floor(N/cells) or
    ceil(N/cells) particles, the ceil-count cells spread evenly through the
    row-major cell order, each cell's particles on the first slots of an
    m^dim sub-grid (m = ceil(count^(1/dim))). Computed in float64 on the
    host and rounded to f32, as the JAX package does, so occupancy starts
    bounded by ceil(N/cells) and nmax can be sized for the fluid.
    """
    dim, n = cfg.dim, cfg.n_atoms
    cps = cfg.cells_per_side
    n_cells = cps ** dim
    w = cfg.cell_width
    base, rem = divmod(n, n_cells)
    top = base + (1 if rem else 0)
    if top > cfg.nmax:
        raise ValueError(f"stratified init needs nmax >= ceil(N/cells) = "
                         f"{top}, got {cfg.nmax}")
    counts = np.full((n_cells,), base, np.int32)
    if rem:
        counts[np.round(np.linspace(0, n_cells - 1, rem)).astype(int)] += 1
    m = max(int(np.ceil(top ** (1.0 / dim) - 1e-9)), 1)
    sub = np.stack(np.meshgrid(*([np.arange(m)] * dim), indexing="ij"),
                   axis=-1).reshape(-1, dim)             # [m^dim, dim]
    cell_idx = np.repeat(np.arange(n_cells), counts)
    slot_in_cell = np.arange(n) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    cid = np.stack([(cell_idx // cps**k) % cps
                    for k in range(dim - 1, -1, -1)], axis=-1)  # [N, dim]
    pos = (cid * w - cfg.box_length / 2.0
           + (sub[slot_in_cell] + 0.5) * (w / m))
    return torch.as_tensor(pos.astype(np.float32), device=device)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def cell_coords(cfg: SimConfig, positions: torch.Tensor) -> torch.Tensor:
    """Integer cell index per axis, [N, dim], for coords in [-L/2, L/2)."""
    w = cfg.cell_width
    c = torch.floor((positions + cfg.box_length / 2.0) / w).to(torch.int32)
    return torch.clamp(c, 0, cfg.cells_per_side - 1)


def _flat_slot(cfg: SimConfig, c: torch.Tensor) -> torch.Tensor:
    """Flatten (color, block) of per-axis cell indices c [N, dim] into one id
    laid out exactly like pos.reshape(ncolors * cells_per_color, ...)."""
    o = c & 1
    b = c >> 1
    color = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    blk = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for k in range(cfg.dim):
        color = color + (o[..., k].long() << k)
        blk = blk * cfg.half_cps + b[..., k].long()  # row-major over axes
    return color * cfg.cells_per_color + blk


def bin_particles(cfg: SimConfig, positions: torch.Tensor,
                  extra: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter [N, dim] positions into color-blocked slabs.

    Stable sort by cell, rank within the cell, scatter; particles ranked
    beyond nmax are dropped and raise the overflow flag. ``extra`` ([N, E]
    float) appends E per-particle attribute planes after the coordinates
    (a mixture's species id), which ride with their slot through every
    shift and neighbor read.

    Returns:
      pos [ncolors, dim (+E), nmax, *bs] f32, occ [ncolors, *bs] i32,
      overflow (0-d bool tensor).
    """
    dev = positions.device
    n = positions.shape[0]
    positions = wrap_into_box(positions.to(torch.float32), cfg.box_length)
    g = _flat_slot(cfg, cell_coords(cfg, positions))
    n_slots = cfg.n_colors * cfg.cells_per_color
    data = positions if extra is None else torch.cat(
        [positions, extra.to(device=dev, dtype=torch.float32)], dim=1)
    n_planes = data.shape[1]

    order = torch.argsort(g, stable=True)
    g_sorted = g[order]
    data_sorted = data[order]
    first = torch.searchsorted(g_sorted, g_sorted, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < cfg.nmax

    slabs = torch.zeros((n_slots, cfg.nmax, n_planes), dtype=torch.float32,
                        device=dev)
    slabs[g_sorted[keep], rank[keep]] = data_sorted[keep]
    occ = torch.bincount(g, minlength=n_slots).to(torch.int32)
    overflow = (occ > cfg.nmax).any()
    occ = torch.clamp(occ, max=cfg.nmax)

    pos = slabs.reshape((cfg.n_colors, *cfg.block_shape, cfg.nmax, n_planes))
    pos = torch.movedim(pos, (-1, -2), (1, 2)).contiguous()
    occ = occ.reshape((cfg.n_colors, *cfg.block_shape))
    return pos, occ, overflow


def unbin(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
          n_out: int | None = None) -> torch.Tensor:
    """Flatten slabs back to [n_out, dim (+E)] in deterministic slot order;
    attribute planes come back as trailing columns."""
    if n_out is None:
        n_out = cfg.n_atoms
    n_planes = pos.shape[1]
    p = torch.movedim(pos, (1, 2), (-1, -2))  # [colors, *bs, nmax, planes]
    flat_pos = p.reshape((-1, n_planes))
    slot = torch.arange(cfg.nmax, device=pos.device)
    valid = (slot[None, :] < occ.reshape((-1,))[:, None]).reshape((-1,))
    idx = torch.argsort((~valid).to(torch.uint8), stable=True)[:n_out]
    return flat_pos[idx]


# ---------------------------------------------------------------------------
# Neighborhood access
# ---------------------------------------------------------------------------

def neighbor_stack(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                   color: int, unwrap: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """All 3^dim - 1 neighbor slabs of every active cell of ``color``.

    Returns nbr_pos [K, planes, nmax, *bs] and nbr_occ [K, *bs],
    K = 3^dim - 1, in ``neighbor_plan`` order. With ``unwrap``, coordinate
    plane k < dim of a read whose block shift wrapped around the box gets
    ±L added (an f32 add, as in the JAX package), so pair loops need no
    minimum image; attribute planes are read as they are.
    """
    dim = cfg.dim
    half = cfg.half_cps
    box = cfg.box_length
    bs = tuple(occ.shape[1:])
    edge_masks = {}
    if unwrap:
        for k in range(dim):
            bk = block_index(bs, k, pos.device)
            edge_masks[(k, 1)] = (bk == half - 1).to(torch.float32)
            edge_masks[(k, -1)] = (bk == 0).to(torch.float32)
    ps, os_ = [], []
    for src_color, shifts in neighbor_plan(dim, color):
        nb = roll_shift(pos[src_color], shifts)
        if unwrap and any(shifts):
            nb = nb.clone()
            for k in range(dim):
                s = shifts[k]
                if s:
                    nb[k] = nb[k] + ((s * box) * edge_masks[(k, s)])[None]
        ps.append(nb)
        os_.append(roll_shift(occ[src_color], shifts))
    return torch.stack(ps, dim=0), torch.stack(os_, dim=0)


# ---------------------------------------------------------------------------
# Random grid shift
# ---------------------------------------------------------------------------

def _shift_rebin_axis(cfg: SimConfig, axis: int, pos: torch.Tensor,
                      occ: torch.Tensor, d: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid shift along ``axis`` by d in (-w/2, w/2] (packed merge).

    Every coordinate moves x_axis -> wrap(x_axis - d) (all coordinate planes
    go through the wrap, as in the JAX package); each cell's new slab is its
    own slab merged with one donor neighbor's slab, in candidate order own
    0..nmax-1 then donor 0..nmax-1. The receiver claims a donor candidate on
    exact floor equality; the owner keeps what the receiver does not claim.
    Binning multiplies by the f32 reciprocal of w. Attribute planes (every
    plane after the first dim, a mixture's species id) move with their slot
    untouched. Unlike the JAX package, a coordinate that stays in its cell
    is never carried across the periodic seam (see the seam guard below);
    otherwise the result is the JAX package's bit for bit.
    """
    w = cfg.cell_width
    dim, nmax = cfg.dim, cfg.nmax
    n_planes = pos.shape[1]
    dev = pos.device
    donor_dir = 1 if bool(d > 0) else -1

    coords = pos[:, :dim]
    moved = coords.clone()
    moved[:, axis] = coords[:, axis] - d
    wrapped = wrap_into_box(moved, cfg.box_length)
    # Seam guard, the port's one departure from the JAX package: a slot at
    # (or an ulp past) +L/2 wraps to -L/2, the far side of the box, while it
    # stays in its cell (every coordinate plane goes through the wrap; on
    # the shift axis the owner keeps what the receiver does not claim).
    # Neighbor reads then unwrap it the wrong way and overlap tests miss it.
    # So a coordinate that stays in its cell is never carried across the
    # seam: a jump of more than L/2 is undone by adding back +-L.
    jumped = (wrapped - coords).abs() > cfg.box_length / 2.0
    back = torch.where(coords > 0, cfg.box_length, -cfg.box_length)
    stays = torch.cat([torch.where(jumped, wrapped + back, wrapped),
                       pos[:, dim:]], dim=1)

    bs = tuple(occ.shape[1:])
    slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * dim)
    own_half = (torch.arange(2 * nmax, device=dev) < nmax).reshape(
        (2 * nmax,) + (1,) * dim)
    inv_w = float(np.float32(1.0 / w))
    bk = block_index(bs, axis, dev)
    pos_out, occ_out = [], []
    for color in range(cfg.n_colors):
        o = color_bits(color, dim)
        t = o[axis] + donor_dir
        src_color = color ^ (1 << axis)  # parity flips along `axis`
        shifts = [0] * dim
        shifts[axis] = t >> 1
        # own slots are stored seam-guarded on every coordinate plane; donor
        # slots on every one but the shift axis, where they really cross
        # cells. Binning reads the wrapped shift-axis coordinate of both.
        donp = stays[src_color].clone()
        donp[axis] = wrapped[src_color, axis]
        donp = roll_shift(donp, tuple(shifts))
        own_o = occ[color]
        don_o = roll_shift(occ[src_color], tuple(shifts))

        cand = torch.cat([stays[color], donp], dim=1)  # [planes, 2nmax, *bs]
        cand_valid = torch.cat([slot < own_o[None], slot < don_o[None]], dim=0)
        xk = torch.cat([wrapped[color, axis], donp[axis]])   # [2nmax, *bs]
        cell_k = torch.floor((xk + cfg.box_length / 2.0) * inv_w).to(torch.int32)
        cell_k = torch.clamp(cell_k, 0, cfg.cells_per_side - 1)
        my_k = (2 * bk + o[axis])[None]
        recv_k = torch.remainder(my_k - donor_dir, cfg.cells_per_side)
        belongs = cand_valid & torch.where(own_half, cell_k != recv_k,
                                           cell_k == my_k)

        csum = torch.cumsum(belongs.to(torch.int32), dim=0)
        dest = csum - 1
        out = torch.zeros((n_planes, nmax) + bs, dtype=cand.dtype,
                          device=dev)
        for j in range(2 * nmax):
            hit = belongs[j][None] & (dest[j][None] == slot)   # [nmax, *bs]
            out = torch.where(hit[None], cand[:, j][:, None], out)
        pos_out.append(out)
        occ_out.append(csum[-1].to(torch.int32))
    occ_new = torch.stack(occ_out)
    overflow = (occ_new > nmax).any()
    return torch.stack(pos_out), torch.clamp(occ_new, max=nmax), overflow


def shift_rebin(cfg: SimConfig, pos: torch.Tensor, occ: torch.Tensor,
                axis: int | torch.Tensor, d: float | torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random grid shift: axis in [0, dim), f32 distance d in (-w/2, w/2].

    Plain version; reads ``axis`` and the sign of ``d`` on the host.
    Returns (pos, occ, overflow) as new tensors.
    """
    d = torch.as_tensor(d, dtype=torch.float32, device=pos.device)
    return _shift_rebin_axis(cfg, int(axis), pos, occ, d.reshape(()))
