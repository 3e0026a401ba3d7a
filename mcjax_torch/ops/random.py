"""The random-number seam between a sweep and where its numbers come from.

A provider hands a sweep its schedule and each color sub-step its random
tensors, with the shapes and meaning of the JAX package's draws
(``mcjax.ops.sweep.mc_sweep`` and ``substep_randoms``):

* ``schedule(cfg, sweep)`` -> ``(perm, axis, d)``: the color permutation
  (int32 [n_colors]), the shift axis (int32 0-d) and the shift distance
  (float32 0-d, uniform in [-w/2, w/2)), all on the provider's device;
* ``substep(cfg, sweep, i, need_acc)`` -> ``(pick_u, disp, acc_u)`` for the
  i-th sub-step of the sweep (position i in the permutation):
  pick_u [n_moves, *bs] uniform in [0, 1), disp [n_moves, dim, *bs]
  (uniform in [-step, step) or gaussian × step), and acc_u [n_moves, *bs]
  uniform in [0, 1), or None when ``need_acc`` is False (hard-core models
  never read it).

``TorchRandoms`` draws these on the device from one explicit
``torch.Generator``; nothing reads PyTorch's global generator. Tests plug in
a provider that evaluates the JAX package's own Threefry key tree, which
makes hard-core trajectories bitwise comparable with it.
"""

from __future__ import annotations

from typing import Protocol

import torch

from mcjax_torch.core.config import SimConfig


class RandomProvider(Protocol):
    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]: ...

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]: ...


class TorchRandoms:
    """Draws every random tensor of a run from one ``torch.Generator``.

    The numbers are drawn on the generator's device in call order; the
    ``sweep`` and ``i`` arguments only fix shapes. Nothing here waits for the
    device.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def schedule(self, cfg: SimConfig, sweep: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        g, dev = self.generator, self.device
        perm = torch.randperm(cfg.n_colors, generator=g, device=dev,
                              dtype=torch.int32)
        axis = torch.randint(0, cfg.dim, (), generator=g, device=dev,
                             dtype=torch.int32)
        half_w = cfg.cell_width / 2.0
        d = torch.empty((), dtype=torch.float32, device=dev).uniform_(
            -half_w, half_w, generator=g)
        return perm, axis, d

    def substep(self, cfg: SimConfig, sweep: int, i: int, need_acc: bool
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        g, dev = self.generator, self.device
        n_m, dim, bs = cfg.n_moves, cfg.dim, cfg.block_shape
        pick_u = torch.rand((n_m, *bs), generator=g, device=dev)
        disp = torch.empty((n_m, dim, *bs), dtype=torch.float32, device=dev)
        if cfg.proposal == "gaussian":
            disp.normal_(0.0, cfg.step_size, generator=g)
        else:
            disp.uniform_(-cfg.step_size, cfg.step_size, generator=g)
        acc_u = (torch.rand((n_m, *bs), generator=g, device=dev)
                 if need_acc else None)
        return pick_u, disp, acc_u
