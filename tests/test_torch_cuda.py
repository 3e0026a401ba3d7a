"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. On the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the repo's conftest imports jax, which the card's machine
need not have).
"""

import math

import pytest
import torch

import mcjax_torch as mt
from mcjax_torch import bench
from mcjax_torch.ops import cuda_shift, cuda_substep, mixture
from mcjax_torch.ops.random import TorchRandoms

pytestmark = pytest.mark.cuda


def _cfg(n, nmax):
    box = math.sqrt(n * math.pi / 4 / 0.5)
    cps = int(box // 2) - int(box // 2) % 2
    return mt.SimConfig(dim=2, n_atoms=n, box_length=box,
                        cells_per_side=cps, nmax=nmax,
                        n_moves=16, proposal="uniform", step_size=0.18,
                        beta=1.0, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,nmax", [(4096, 7), (1000, 5), (4096, 12)])
def test_sweep_kernels_match_plain(cuda, n, nmax):
    cfg, pot = _cfg(n, nmax), mt.HardSphere(1.0)
    st = mt.init_state(cfg, cuda)
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(n + nmax))
    st, _ = mt.run_sweeps(cfg, pot, st, 2, rnd)     # leave the lattice
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    for i in range(cfg.n_colors):
        pick_u, disp, _ = rnd.substep(cfg, st.sweep, i, False)
        color = int(perm[i])
        own, _, acc, prop = cuda_substep.color_substep(
            cfg, pot, color, st.pos, st.occ, pick_u, disp)
        before = cuda_substep.LIB.launches
        _, k_acc, k_prop = cuda_substep.substep(cfg, pot, st.pos, st.occ,
                                                perm, i, pick_u, disp)
        torch.cuda.synchronize()
        assert cuda_substep.LIB.launches == before + 1
        assert torch.equal(st.pos[color].view(torch.int32),
                           own.view(torch.int32))
        assert int(k_acc) == int(acc) and int(k_prop) == int(prop)
    for ax in range(2):
        for sign in (1, -1):
            a = torch.tensor(ax, dtype=torch.int32, device=cuda)
            dd = (sign * d.abs()).contiguous()
            want = cuda_shift.shift_rebin(cfg, st.pos, st.occ, a, dd)
            got = cuda_shift.shift(cfg, st.pos, st.occ, a, dd)
            torch.cuda.synchronize()
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("axis,past", [(0, 0), (1, 1)])
def test_shift_kernel_seam_guard(cuda, axis, past):
    """The kernel's seam guard equals the plain version's (see
    test_torch_cells.py::test_shift_keeps_seam_coordinates_on_their_side)."""
    cfg = _cfg(4096, 7).replace(n_atoms=1)
    h = torch.tensor(cfg.box_length / 2, dtype=torch.float32)
    y = h if not past else torch.nextafter(h, torch.tensor(float("inf")))
    st = mt.zeros_state(cfg, cuda)
    top = cfg.half_cps - 1
    st.occ[2, 3, top] = 1
    st.pos[2, 0, 0, 3, top] = 6.5 * cfg.cell_width - float(h)
    st.pos[2, 1, 0, 3, top] = y.to(cuda)
    a = torch.tensor(axis, dtype=torch.int32, device=cuda)
    d = torch.tensor(0.3 if axis == 0 else float(h) * 2.0**-26,
                     dtype=torch.float32, device=cuda)
    want = cuda_shift.shift_rebin(cfg, st.pos, st.occ, a, d)
    got = cuda_shift.shift(cfg, st.pos, st.occ, a, d)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    (c, b0, b1), = torch.nonzero(got[1]).tolist()
    assert float(got[0][c, 1, 0, b0, b1]) > 0


def _shift_kernel_matches_plain(cfg, st, d):
    for ax in range(cfg.dim):
        for sign in (1, -1):
            a = torch.tensor(ax, dtype=torch.int32, device=st.pos.device)
            dd = (sign * d.abs()).contiguous()
            want = cuda_shift.shift_rebin(cfg, st.pos, st.occ, a, dd)
            got = cuda_shift.shift(cfg, st.pos, st.occ, a, dd)
            torch.cuda.synchronize()
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("n,nmax", [(4000, 24), (3000, 16)])
def test_lj_kernels_match_plain(cuda, n, nmax):
    """The 3D LJ sub-step kernel against its plain version for all 8
    colors (bit for bit outside cells where a decision came within a
    relative 1e-5 of a tie; dE per cell within 1e-5 relative + 1e-4), and
    the 3D shift kernel bit for bit for 3 axes x 2 signs of d."""
    cfg, pot, st = bench.build_lj3d(n, nmax, 16, device=cuda)
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(n + nmax))
    st, _ = mt.run_sweeps(cfg, pot, st, 2, rnd)     # leave the start
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    for i in range(cfg.n_colors):
        pick_u, disp, acc_u = rnd.substep(cfg, st.sweep, i, True)
        color = int(perm[i])
        rec = {}
        own, de, acc, prop = cuda_substep.color_substep(
            cfg, pot, color, st.pos, st.occ, pick_u, disp, acc_u, rec)
        before = cuda_substep.LIB_LJ.launches
        k_de, k_acc, k_prop = cuda_substep.substep(
            cfg, pot, st.pos, st.occ, perm, i, pick_u, disp, acc_u)
        torch.cuda.synchronize()
        assert cuda_substep.LIB_LJ.launches == before + 1
        differs = (st.pos[color].view(torch.int32)
                   != own.view(torch.int32)).any(dim=0).any(dim=0)
        ties = rec["margin"] <= 1e-5
        assert not bool((differs & ~ties).any())
        assert int(k_prop) == int(prop)
        if not bool(differs.any()):
            assert int(k_acc) == int(acc)
            assert abs(float(k_de) - float(de)) <= 1e-5 * abs(float(de)) + 1e-4
    _shift_kernel_matches_plain(cfg, st, d)


@pytest.mark.parametrize("seam_axis", range(3))
def test_shift_kernel_seam_guard_3d(cuda, seam_axis):
    """A slot at +L/2 on each axis, shifted along the next axis: the
    kernel equals the plain version and keeps the slot at +L/2."""
    cfg, _, _ = bench.build_lj3d(4000, 24, 16, device="cpu")
    cfg = cfg.replace(n_atoms=1)
    h = float(torch.tensor(cfg.box_length / 2, dtype=torch.float32))
    st = mt.zeros_state(cfg, cuda)
    blk = [1, 1, 1]
    blk[seam_axis] = cfg.half_cps - 1
    color = 1 << seam_axis            # odd cell on the seam axis: the top
    st.occ[(color, *blk)] = 1
    x = [(2 * b + 0.5) * cfg.cell_width - h for b in blk]
    x[seam_axis] = h
    st.pos[(color, slice(None), 0, *blk)] = torch.tensor(x, device=cuda)
    a = torch.tensor((seam_axis + 1) % 3, dtype=torch.int32, device=cuda)
    d = torch.tensor(0.3, dtype=torch.float32, device=cuda)
    want = cuda_shift.shift_rebin(cfg, st.pos, st.occ, a, d)
    got = cuda_shift.shift(cfg, st.pos, st.occ, a, d)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    (c, *b), = torch.nonzero(got[1]).tolist()
    assert float(got[0][(c, seam_axis, 0, *b)]) > 0


@pytest.mark.parametrize("n,nmax", [(4500, 34), (2800, 64)])
def test_mixture_kernel_matches_plain(cuda, n, nmax):
    """The Kob-Andersen sub-step kernel against its plain version for all
    8 colors (bit for bit, species plane included, outside cells where a
    decision came within a relative 1e-5 of a tie; dE within 1e-5 relative
    + 1e-4), and the shift kernel with the species plane bit for bit for
    3 axes x 2 signs of d. At 2,800 atoms the cells hold about 44, so
    both own slots of a lane are in use."""
    cfg, pot, st = bench.build_ka3d(n, nmax, 16, device=cuda)
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(n + nmax))
    st, _ = mt.run_sweeps(cfg, pot, st, 2, rnd)     # leave the start
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    for i in range(cfg.n_colors):
        pick_u, disp, acc_u = rnd.substep(cfg, st.sweep, i, True)
        color = int(perm[i])
        rec = {}
        own, de, acc, prop = mixture.color_substep_mixture(
            cfg, pot, color, st.pos, st.occ, pick_u, disp, acc_u, rec)
        before = cuda_substep.LIB_MIX.launches
        k_de, k_acc, k_prop = cuda_substep.substep(
            cfg, pot, st.pos, st.occ, perm, i, pick_u, disp, acc_u)
        torch.cuda.synchronize()
        assert cuda_substep.LIB_MIX.launches == before + 1
        differs = (st.pos[color].view(torch.int32)
                   != own.view(torch.int32)).any(dim=0).any(dim=0)
        ties = rec["margin"] <= 1e-5
        assert not bool((differs & ~ties).any())
        assert int(k_prop) == int(prop)
        if not bool(differs.any()):
            assert int(k_acc) == int(acc)
            assert abs(float(k_de) - float(de)) <= 1e-5 * abs(float(de)) + 1e-4
    _shift_kernel_matches_plain(cfg, st, d)
    n_b = n // 5
    mt.validate_state(cfg, st, pot, expect_species=[n - n_b, n_b])
