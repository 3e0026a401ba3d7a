"""Contact-shell observables of hard disks and spheres (twin of the parts
of ``mcjax.utils.observables`` that the statistical RNG gate reads).

``contact_shell_gr_cells`` histograms g(r) just outside contact from the
color-blocked state through the cell lists, O(N x neighborhood), so it
runs at a million particles; ``hard_disk_eos_state`` turns the contact
value g(d+) into the compressibility factor Z = P / (rho kT).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcjax_torch.core.config import SimConfig
from mcjax_torch.core.geometry import min_image
from mcjax_torch.ops import cells
from mcjax_torch.ops.cuda_substep import squared_norm


def contact_shell_gr_cells(cfg: SimConfig, pos: torch.Tensor,
                           occ: torch.Tensor, diameter: float, n_bins: int,
                           window: float) -> torch.Tensor:
    """g(r) on n_bins bins of [d, d (1 + window)) from the cell lists
    (``mcjax.utils.observables.contact_shell_gr_cells``), float32
    [n_bins] on the state's device. Every ordered pair is seen twice over
    the colors and counts 1/2 each time. Raises ValueError when the shell
    reaches beyond one cell width, where the one-ring neighbor stack would
    miss pairs."""
    if diameter * (1.0 + window) > cfg.cell_width + 1e-9:
        raise ValueError(
            f"contact shell extends to {diameter * (1 + window)} but "
            f"cell_width is {cfg.cell_width}; one-ring coverage would miss "
            "pairs - enlarge cells or shrink the window")
    nmax, dim = cfg.nmax, cfg.dim
    dev = pos.device
    dr = diameter * window / n_bins
    lo2 = diameter * diameter
    hi = diameter * (1.0 + window)
    counts = torch.zeros(n_bins, dtype=torch.float32, device=dev)

    def add_pairs(counts, r2, valid):
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        inside = valid & (r2 >= lo2) & (r < hi)
        bins = torch.floor((r - diameter) / dr).to(torch.int64)
        keep = inside & (bins >= 0) & (bins < n_bins)
        return counts.index_add(0, bins[keep],
                                torch.full_like(r[keep], 0.5))

    for color in range(cfg.n_colors):
        own = pos[color, :dim]                               # [dim, nmax, *bs]
        own_occ = occ[color]
        bs = tuple(own_occ.shape)
        slot = torch.arange(nmax, device=dev).reshape((nmax,) + (1,) * len(bs))
        valid_i = slot < own_occ[None]
        d = min_image(own[:, :, None] - own[:, None, :], cfg.box_length)
        not_self = ~torch.eye(nmax, dtype=torch.bool, device=dev).reshape(
            (nmax, nmax) + (1,) * len(bs))
        counts = add_pairs(counts, squared_norm(d, 0),
                           valid_i[:, None] & valid_i[None, :] & not_self)
        nbr_pos, nbr_occ = cells.neighbor_stack(cfg, pos, occ, color)
        valid_j = slot[None] < nbr_occ[:, None]
        dx = own[None, :, :, None] - nbr_pos[:, :dim, None, :]
        counts = add_pairs(counts, squared_norm(dx, 1),
                           valid_i[None, :, None] & valid_j[:, None, :])

    n_tot = occ.sum().to(torch.float32)
    centers = diameter + (torch.arange(n_bins, device=dev,
                                       dtype=torch.float32) + 0.5) * dr
    rho = n_tot / cfg.box_length ** dim
    shell = (2.0 * math.pi * centers * dr if dim == 2
             else 4.0 * math.pi * centers ** 2 * dr)
    ideal = n_tot * rho * shell / 2.0
    return counts / ideal


def hard_disk_eos_state(cfg: SimConfig, states_pos_occ, diameter: float,
                        n_bins: int = 12, window: float = 0.05,
                        order: int = 2) -> float:
    """Z = P / (rho kT) of hard disks (1 + 2 phi g(d+)) or spheres (1 + 4
    phi g(d+)) from one (pos, occ) snapshot or a list of them, g(d+) from a
    polynomial fit of ``contact_shell_gr_cells`` extrapolated to r = d
    (``mcjax.utils.observables.hard_disk_eos_state``)."""
    snaps = states_pos_occ if isinstance(states_pos_occ, list) \
        else [states_pos_occ]
    g_sum = None
    for p, o in snaps:
        g = contact_shell_gr_cells(cfg, p, o, diameter, n_bins, window)
        g_sum = g if g_sum is None else g_sum + g
    g_mean = g_sum.cpu().numpy() / len(snaps)
    dr = diameter * window / n_bins
    centers = diameter + (np.arange(n_bins) + 0.5) * dr
    coef = np.polyfit(centers, g_mean, min(order, n_bins - 1))
    g_contact = float(np.polyval(coef, diameter))
    n = int(snaps[0][1].sum())
    volume = cfg.box_length ** cfg.dim
    if cfg.dim == 2:
        phi = n * math.pi * diameter ** 2 / 4.0 / volume
        return 1.0 + 2.0 * phi * g_contact
    phi = n * math.pi * diameter ** 3 / 6.0 / volume
    return 1.0 + 4.0 * phi * g_contact
