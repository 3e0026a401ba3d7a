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
from mcjax_torch.ops import cells, cuda_shift, cuda_substep, mixture
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


def _disk_case(case, device):
    """(cfg, pot, state, provider) of a one-launch sub-step case.

    (n, nmax): n disks after two sweeps. ``sparse``: 120 disks in 1,600
    cells, so most cells are empty and the rest hold one or two. ``full``:
    every cell holds 16 disks of diameter 0.45 on a jittered 4 x 4 lattice
    of spacing w / 4, so a cell keeps about 20 frozen slots, past the
    kernel's 16 staged ones, and the overflow pass decides moves."""
    if case == "sparse":
        cfg = _cfg(4096, 7).replace(n_atoms=120)
        g = torch.Generator().manual_seed(3)
        x = (torch.rand(120, 2, generator=g) - 0.5) * cfg.box_length
        return (cfg, mt.HardSphere(1.0), mt.init_state(cfg, device, x),
                TorchRandoms(torch.Generator(device).manual_seed(5)))
    if case == "full":
        cfg = _cfg(4096, 16)
        cps = cfg.cells_per_side
        cfg = cfg.replace(n_atoms=16 * cps * cps)
        g = torch.Generator().manual_seed(9)
        cell = torch.stack(torch.meshgrid(torch.arange(cps),
                                          torch.arange(cps), indexing="ij"),
                           -1).reshape(-1, 1, 2)
        grid = torch.stack(torch.meshgrid(torch.arange(4), torch.arange(4),
                                          indexing="ij"), -1).reshape(1, 16, 2)
        jitter = 0.04 * (torch.rand(cps * cps, 16, 2, generator=g) - 0.5)
        x = ((cell + (grid + 0.5) / 4 + jitter) * cfg.cell_width
             - cfg.box_length / 2).reshape(-1, 2)
        return (cfg, mt.HardSphere(0.45), mt.init_state(cfg, device, x),
                TorchRandoms(torch.Generator(device).manual_seed(11)))
    n, nmax = case
    cfg, pot = _cfg(n, nmax), mt.HardSphere(1.0)
    rnd = TorchRandoms(torch.Generator(device).manual_seed(n + nmax))
    st, _ = mt.run_sweeps(cfg, pot, mt.init_state(cfg, device), 2, rnd)
    return cfg, pot, st, rnd


@pytest.mark.parametrize("case,start", [((4096, 7), 0), ((4096, 7), 1),
                                        ((1000, 5), 2), ((4096, 12), 0),
                                        ("sparse", 0), ("full", 0)])
def test_one_launch_substeps_match_plain(cuda, case, start):
    """The 2D kernel's one launch of sub-steps [start, start + k), for
    every k up to the end of the sweep, against k plain sub-steps, bit for
    bit: pos, occ, and accepted and proposed moves of each sub-step. In the
    ``full`` case the overflow pass runs (counted) and decides moves."""
    cfg, pot, st, rnd = _disk_case(case, cuda)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, False)
             for i in range(start, cfg.n_colors)]
    plain, occ = st.pos.clone(), st.occ.clone()
    acc, prop = [], []
    stats = cuda_substep.kernel_stats(cuda)
    for k, (pick_u, disp, _) in enumerate(draws, start=1):
        color = int(perm[start + k - 1])
        own, _, a, p = cuda_substep.color_substep(cfg, pot, color, plain, occ,
                                                  pick_u, disp)
        plain[color] = own
        acc.append(int(a))
        prop.append(int(p))
        pos = st.pos.clone()
        stats.zero_()
        before = cuda_substep.LIB.launches
        de, k_acc, k_prop = cuda_substep.substeps(cfg, pot, pos, st.occ,
                                                  perm, draws[:k], start)
        torch.cuda.synchronize()
        assert cuda_substep.LIB.launches == before + 1
        assert torch.equal(pos.view(torch.int32), plain.view(torch.int32))
        assert torch.equal(st.occ, occ)
        assert k_acc.tolist() == acc and k_prop.tolist() == prop
        assert de.tolist() == [0.0] * k
    if case == "full":
        assert int(stats[0]) > 0
        assert 0 < sum(acc) < sum(prop)
    else:
        assert int(stats[0]) == 0


def _f32_steps(x, ulps):
    """Float32 ``x`` moved by ``ulps`` float32 steps (toward +inf when
    positive); any shape."""
    t = torch.as_tensor(x, dtype=torch.float32)
    to = torch.full_like(t, math.copysign(math.inf, ulps))
    for _ in range(abs(ulps)):
        t = torch.nextafter(t, to)
    return t


def _disk_edge_state(ulps, device, reach=1.0):
    """A 2D state on the culling boundary. Each of 8 own cells of color 0
    holds one disk on the face or corner of its cell that faces one of the
    8 neighbor directions (on the cell's bound: its lower bound, or the
    float32 below its upper bound); that neighbor holds one disk at
    ``reach`` (the diameter, 1, or the stored-frame diameter 1 / s of an
    NPT scale s) from it along the direction, moved ``ulps`` float32 ulps
    along the direction on each axis it faces. Returns (cfg, pot, state)."""
    cfg = mt.SimConfig(dim=2, n_atoms=16, box_length=32.0, cells_per_side=16,
                       nmax=4, n_moves=1, proposal="uniform", step_size=0.18,
                       beta=1.0)
    w, h = cfg.cell_width, cfg.box_length / 2
    pos = torch.zeros((4, 2, cfg.nmax, *cfg.block_shape))
    occ = torch.zeros((4, *cfg.block_shape), dtype=torch.int32)
    for k, dvec in enumerate(cells.neighbor_offsets(2)):
        blk = (2 * (k % 4), 2 * (k // 4))
        lb = cuda_substep.cell_lower_bounds(cfg, 0, cfg.block_shape,
                                            torch.device("cpu"))[:, blk[0],
                                                                 blk[1]]
        hi = lb + torch.tensor(w, dtype=torch.float32)
        x = torch.stack([lb[a] if dvec[a] < 0 else
                         _f32_steps(hi[a], -1) if dvec[a] > 0 else
                         lb[a] + w / 2 for a in range(2)])
        norm = math.sqrt(sum(v * v for v in dvec))
        y = x + torch.tensor([reach * v / norm for v in dvec])
        y = torch.stack([_f32_steps(y[a], ulps * dvec[a]) if dvec[a] else y[a]
                         for a in range(2)])
        occ[(0, *blk)] = 1
        pos[(0, slice(None), 0, *blk)] = x
        ncell = [2 * b + v for b, v in zip(blk, dvec)]
        color = sum((c % 2) << a for a, c in enumerate(ncell))
        nblk = tuple((c // 2) % cfg.half_cps for c in ncell)
        y = y + torch.tensor([cfg.box_length if c < 0 else 0.0
                              for c in ncell])
        occ[(color, *nblk)] = 1
        pos[(color, slice(None), 0, *nblk)] = y
    st = mt.SimState(pos=pos.to(device), occ=occ.to(device), sweep=0,
                     overflow=torch.zeros((), dtype=torch.bool, device=device))
    return cfg, mt.HardSphere(1.0), st


@pytest.mark.parametrize("ulps", [-4, -3, -2, -1, 1, 2, 3, 4])
def test_disk_kernel_at_the_cull_edge(cuda, ulps):
    """Frozen disks 1-4 float32 ulps inside and outside the diameter of an
    own disk on each face and corner of its cell (on the cell's bound),
    which proposes to stay where it is: the kernel, whose culling must
    keep every frozen disk that overlaps, equals the plain version bit for
    bit, and the plain version rejects where the frozen disk is inside."""
    cfg, pot, st = _disk_edge_state(ulps, cuda)
    bs = cfg.block_shape
    perm = torch.arange(4, dtype=torch.int32, device=cuda)
    pick_u = torch.zeros((1, *bs), device=cuda)
    disp = torch.zeros((1, 2, *bs), device=cuda)
    own, _, acc, prop = cuda_substep.color_substep(cfg, pot, 0, st.pos,
                                                   st.occ, pick_u, disp)
    _, k_acc, k_prop = cuda_substep.substep(cfg, pot, st.pos, st.occ, perm,
                                            0, pick_u, disp)
    torch.cuda.synchronize()
    assert torch.equal(st.pos[0].view(torch.int32), own.view(torch.int32))
    assert (int(k_acc), int(k_prop)) == (int(acc), int(prop))
    assert int(prop) == 8
    if abs(ulps) >= 2:
        assert int(acc) == (8 if ulps > 0 else 0)


@pytest.mark.parametrize("scale", [0.97, 1.03])
@pytest.mark.parametrize("ulps", [-4, -1, 1, 4])
def test_disk_npt_kernel_at_the_cull_edge(cuda, ulps, scale):
    """The NPT form at the culling edge: frozen disks 1-4 float32 ulps in
    and out of the stored-frame diameter 1 / s, where the kernel's reach is
    its own division by s^2; the kernel equals the plain version at that
    scale bit for bit."""
    cfg, pot, st = _disk_edge_state(ulps, cuda, 1.0 / scale)
    bs = cfg.block_shape
    perm = torch.arange(4, dtype=torch.int32, device=cuda)
    pick_u = torch.zeros((1, *bs), device=cuda)
    disp = torch.zeros((1, 2, *bs), device=cuda)
    s = torch.tensor(scale, device=cuda)
    own, _, acc, prop = cuda_substep.color_substep(
        cfg, pot, 0, st.pos, st.occ, pick_u, disp, scale=s)
    _, k_acc, k_prop = cuda_substep.substep(cfg, pot, st.pos, st.occ, perm,
                                            0, pick_u, disp, scale=s)
    torch.cuda.synchronize()
    assert torch.equal(st.pos[0].view(torch.int32), own.view(torch.int32))
    assert (int(k_acc), int(k_prop)) == (int(acc), int(prop))
    assert int(prop) == 8


@pytest.mark.parametrize("case", [(4096, 7), (1000, 5), "full"])
@pytest.mark.parametrize("scale", [0.97, 1.0, 1.03])
def test_one_launch_npt_substeps_match_plain(cuda, case, scale):
    """The 2D kernel's NPT form, one launch of a sweep's 4 sub-steps at
    box scale s, against 4 plain sub-steps at s bit for bit (pos and the
    counts); at s = 1 also against the NVT kernel. In the ``full`` case the
    overflow pass runs."""
    cfg, pot, st, rnd = _disk_case(case, cuda)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, False) for i in range(4)]
    s = torch.tensor(scale, device=cuda)
    plain, acc, prop = st.pos.clone(), [], []
    for i, (pick_u, disp, _) in enumerate(draws):
        color = int(perm[i])
        own, _, a, p = cuda_substep.color_substep(cfg, pot, color, plain,
                                                  st.occ, pick_u, disp,
                                                  scale=s)
        plain[color] = own
        acc.append(int(a))
        prop.append(int(p))
    nvt = st.pos.clone()
    if scale == 1.0:
        cuda_substep.substeps(cfg, pot, nvt, st.occ, perm, draws)
    before = (cuda_substep.LIB.launches, cuda_substep.LIB.npt_launches)
    _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, st.pos, st.occ, perm,
                                             draws, scale=s)
    torch.cuda.synchronize()
    assert (cuda_substep.LIB.launches, cuda_substep.LIB.npt_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(st.pos.view(torch.int32), plain.view(torch.int32))
    assert k_acc.tolist() == acc and k_prop.tolist() == prop
    if scale == 1.0:
        assert torch.equal(st.pos.view(torch.int32), nvt.view(torch.int32))


def _full_cells(cfg, st, seed):
    """``st`` with every cell holding nmax slots at uniform points of the
    cell (coordinate planes; attribute planes kept)."""
    pos = st.pos.clone()
    lb = torch.stack([cuda_substep.cell_lower_bounds(
        cfg, c, cfg.block_shape, pos.device) for c in range(cfg.n_colors)])
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(pos[:, :cfg.dim].shape, generator=g).to(pos.device)
    pos[:, :cfg.dim] = lb[:, :, None] + u * cfg.cell_width
    return mt.SimState(pos=pos, occ=torch.full_like(st.occ, cfg.nmax),
                       sweep=st.sweep, overflow=st.overflow)


@pytest.mark.parametrize("form", ["disks", "lj3d", "ka3d"])
def test_shift_kernel_half_width_and_full_cells(cuda, form):
    """The shift kernel against ``shift_rebin``, bit for bit, in 2D, 3D and
    4-plane form (cells a color not a multiple of the kernel's tile: 400
    and 27), on every axis with d = -w/2, the largest float32 below w/2
    and w/2, first on a state after a sweep, then with every cell full,
    where the overflow flag must be raised."""
    if form == "disks":
        cfg, pot = _cfg(4096, 7), mt.HardSphere(1.0)
        st = mt.init_state(cfg, cuda)
    else:
        build = bench.build_lj3d if form == "lj3d" else bench.build_ka3d
        cfg, pot, st = build(*((4000, 24) if form == "lj3d" else (4500, 34)),
                             16, device=cuda)
    assert cfg.cells_per_color % 32 != 0
    st, _ = mt.run_sweeps(cfg, pot, st, 1,
                          TorchRandoms(torch.Generator(cuda).manual_seed(6)))
    hw = torch.tensor(cfg.cell_width / 2, dtype=torch.float32)
    ds = [-hw, _f32_steps(hw, -1), hw]
    raised = 0
    for state in (st, _full_cells(cfg, st, 7)):
        for ax in range(cfg.dim):
            for d in ds:
                a = torch.tensor(ax, dtype=torch.int32, device=cuda)
                dd = d.to(cuda)
                want = cuda_shift.shift_rebin(cfg, state.pos, state.occ, a, dd)
                got = cuda_shift.shift(cfg, state.pos, state.occ, a, dd)
                torch.cuda.synchronize()
                assert torch.equal(got[0].view(torch.int32),
                                   want[0].view(torch.int32))
                assert torch.equal(got[1], want[1])
                assert bool(got[2]) == bool(want[2])
                raised += bool(got[2])
    assert raised > 0


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


def _energetic_case(case, device):
    """(cfg, pot, state, warm-up sweeps) of a kernel-vs-plain case.

    ``lj`` / ``ka`` with (n, nmax): the lj3d / ka3d systems at n atoms.
    ``sparse``: 150 atoms in 216 cells, so the cells hold 0 or 1.
    ``full``: every cell holds nmax (LJ 32, mixture 64) on a sub-grid of
    spacing w / 4, with sigma halved (cutoff ratio 5) so the energies stay
    moderate; the frozen slots within reach of a cell exceed the kernels'
    shared memory, which drives the overflow pass. No warm-up sweep: a
    shift would overflow the full cells."""
    model, layout = case[0], case[1]
    if layout not in ("sparse", "full"):
        build = bench.build_lj3d if model == "lj" else bench.build_ka3d
        return (*build(*layout, 16, device=device), 2)
    full = layout == "full"
    nmax = (32 if model == "lj" else 64) if full else 24
    cfg = mt.SimConfig(dim=3, n_atoms=216 * nmax if full else 150,
                       box_length=6 * 2.55, cells_per_side=6, nmax=nmax,
                       n_moves=16, proposal="gaussian", step_size=0.12,
                       beta=0.3)
    x = cells.stratified_positions(cfg, device)
    sig = 0.5 if full else 1.0
    warm = 0 if full else 2
    if model == "lj":
        return (cfg, mt.LennardJones(sigma=sig, r_cut=2.5),
                mt.init_state(cfg, device, x), warm)
    table = ((sig, 0.8 * sig), (0.8 * sig, 0.88 * sig))
    pot = mt.LJMixture(epsilon=((1.0, 1.5), (1.5, 0.5)), sigma=table,
                       r_cut_table=tuple(tuple(2.5 / sig * v for v in row)
                                         for row in table), shift=True)
    species = (torch.arange(cfg.n_atoms, device=device) % 5 == 4).int()
    return (cfg, pot, mixture.init_mixture_state(cfg, x, species, device),
            warm)


def _energetic_kernel_matches_plain(cuda, case, lib, plain, scale=None):
    """The sub-step kernel of ``lib`` against its plain version for all 8
    colors (bit for bit outside cells where a decision came within a
    relative 1e-5 of a tie; dE per sub-step within 1e-5 relative + 1e-4),
    then the shift kernel bit for bit; returns (cfg, pot, state) and the
    kernels' counters over the 8 sub-steps. With a box ``scale`` the
    kernel's NPT form runs, and the plain version at that scale."""
    cfg, pot, st, warm = _energetic_case(case, cuda)
    seed = cfg.n_atoms + cfg.nmax
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(seed))
    if warm:
        st, _ = mt.run_sweeps(cfg, pot, st, warm, rnd)  # leave the start
    perm, axis, d = rnd.schedule(cfg, st.sweep)
    stats = cuda_substep.kernel_stats(cuda)
    stats.zero_()
    s = None if scale is None else torch.tensor(scale, device=cuda)
    for i in range(cfg.n_colors):
        pick_u, disp, acc_u = rnd.substep(cfg, st.sweep, i, True)
        color = int(perm[i])
        rec = {}
        own, de, acc, prop = plain(cfg, pot, color, st.pos, st.occ, pick_u,
                                   disp, acc_u, rec, scale=s)
        before = (lib.launches, lib.npt_launches)
        k_de, k_acc, k_prop = cuda_substep.substep(
            cfg, pot, st.pos, st.occ, perm, i, pick_u, disp, acc_u, s)
        torch.cuda.synchronize()
        assert (lib.launches, lib.npt_launches) == (
            before[0] + 1, before[1] + (s is not None))
        differs = (st.pos[color].view(torch.int32)
                   != own.view(torch.int32)).any(dim=0).any(dim=0)
        ties = rec["margin"] <= 1e-5
        assert not bool((differs & ~ties).any())
        assert int(k_prop) == int(prop)
        if not bool(differs.any()):
            assert int(k_acc) == int(acc)
            assert abs(float(k_de) - float(de)) <= 1e-5 * abs(float(de)) + 1e-4
    counts = stats.tolist()
    if case[1] != "full":
        _shift_kernel_matches_plain(cfg, st, d)
    return cfg, pot, st, counts


@pytest.mark.parametrize("n,nmax", [(4000, 24), (3000, 16), ("sparse", 24),
                                    ("full", 32)])
def test_lj_kernels_match_plain(cuda, n, nmax):
    """The 3D LJ sub-step kernel against its plain version for all 8
    colors (bit for bit outside cells where a decision came within a
    relative 1e-5 of a tie; dE per cell within 1e-5 relative + 1e-4), and
    the 3D shift kernel bit for bit for 3 axes x 2 signs of d. The
    ``sparse`` case has empty and single-occupant cells; in the ``full``
    one every cell holds 32 and the frozen slots overflow the shared
    memory, so the kernel's overflow pass runs (counted)."""
    layout = n if isinstance(n, str) else (n, nmax)
    _, _, _, counts = _energetic_kernel_matches_plain(
        cuda, ("lj", layout), cuda_substep.LIB_LJ, cuda_substep.color_substep)
    assert counts[1] > 0
    if layout == "full":
        assert counts[0] > 0


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


@pytest.mark.parametrize("n,nmax", [(4500, 34), (2800, 64), ("sparse", 34),
                                    ("full", 64)])
def test_mixture_kernel_matches_plain(cuda, n, nmax):
    """The Kob-Andersen sub-step kernel against its plain version for all
    8 colors (bit for bit, species plane included, outside cells where a
    decision came within a relative 1e-5 of a tie; dE within 1e-5 relative
    + 1e-4), and the shift kernel with the species plane bit for bit for
    3 axes x 2 signs of d. At 2,800 atoms the cells hold about 44, so
    both own slots of a lane are in use; ``sparse`` and ``full`` are the
    LJ test's cases (full: 64 a cell, the overflow pass)."""
    layout = n if isinstance(n, str) else (n, nmax)
    cfg, pot, st, counts = _energetic_kernel_matches_plain(
        cuda, ("ka", layout), cuda_substep.LIB_MIX,
        mixture.color_substep_mixture)
    assert counts[1] > 0
    if layout == "full":
        assert counts[0] > 0
    n_b = cfg.n_atoms // 5
    mt.validate_state(cfg, st, pot,
                      expect_species=[cfg.n_atoms - n_b, n_b])


@pytest.mark.parametrize("model,layout", [("lj", (4000, 24)), ("lj", "full"),
                                          ("ka", (4500, 34)), ("ka", "full")])
@pytest.mark.parametrize("scale", [0.99, 1.02])
def test_energetic_npt_kernels_match_plain(cuda, model, layout, scale):
    """The NPT forms of the LJ and mixture sub-step kernels at box scale s
    (within the one-ring contract of every case) against their plain
    versions at s, under the near-tie rule, for all 8 colors; ``full``
    runs the overflow pass."""
    lib, plain = ((cuda_substep.LIB_LJ, cuda_substep.color_substep)
                  if model == "lj" else
                  (cuda_substep.LIB_MIX, mixture.color_substep_mixture))
    _, _, _, counts = _energetic_kernel_matches_plain(
        cuda, (model, layout), lib, plain, scale)
    assert counts[1] > 0
    if layout == "full":
        assert counts[0] > 0


@pytest.mark.parametrize("model", ["lj", "ka"])
def test_energetic_npt_kernel_at_scale_one_is_nvt(cuda, model):
    """At s = 1 (s^2 = 1 exactly) the NPT form equals the NVT kernel bit
    for bit: positions and both per-cell maps, for all 8 colors."""
    build = bench.build_lj3d if model == "lj" else bench.build_ka3d
    n, nmax = (4000, 24) if model == "lj" else (4500, 34)
    cfg, pot, st = build(n, nmax, 16, device=cuda)
    launch = (cuda_substep.launch_lj_kernel if model == "lj"
              else cuda_substep.launch_mix_kernel)
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(n))
    st, _ = mt.run_sweeps(cfg, pot, st, 2, rnd)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    one = torch.ones((), device=cuda)
    for i in range(cfg.n_colors):
        draws = rnd.substep(cfg, st.sweep, i, True)
        nvt = st.pos.clone()
        maps = [torch.empty(cfg.block_shape, dtype=t, device=cuda)
                for t in (torch.float32, torch.int32) * 2]
        launch(cfg, pot, nvt, st.occ, perm, i, *draws, *maps[:2])
        launch(cfg, pot, st.pos, st.occ, perm, i, *draws, *maps[2:], one)
        torch.cuda.synchronize()
        assert torch.equal(st.pos.view(torch.int32), nvt.view(torch.int32))
        assert torch.equal(maps[0].view(torch.int32),
                           maps[2].view(torch.int32))
        assert torch.equal(maps[1], maps[3])


def _f32_step(x: float, ulps: int) -> float:
    """x moved by ``ulps`` float32 steps (toward +inf when positive)."""
    t = torch.tensor(x, dtype=torch.float32)
    to = torch.tensor(math.copysign(math.inf, ulps), dtype=torch.float32)
    for _ in range(abs(ulps)):
        t = torch.nextafter(t, to)
    return float(t)


def _edge_state(model, ulps, outside, device, scale=1.0):
    """A state built to sit on the culling boundary. Every own cell of
    color 0 at even block indices holds one slot, on the face, edge or
    corner of its cell that faces one of the 26 neighbor directions
    (``outside`` float32 ulps beyond the cell on the axes it faces, as a
    slot can sit after a grid shift); that neighbor holds one slot at
    r_cut (the largest cutoff, 2.5) from it, or at r_cut / s for an NPT
    box scale s, moved ``ulps`` float32 ulps along the direction.
    Unshifted potentials, so a term at r_cut is not 0. Returns (cfg, pot,
    state, the [3, *bs] inward unit steps of color 0)."""
    cfg = mt.SimConfig(dim=3, n_atoms=52, box_length=16 * 2.55,
                       cells_per_side=16, nmax=4, n_moves=1,
                       proposal="gaussian", step_size=0.12, beta=0.3)
    planes = 3 if model == "lj" else 4
    w, h = cfg.cell_width, cfg.box_length / 2
    pos = torch.zeros((8, planes, cfg.nmax, *cfg.block_shape))
    occ = torch.zeros((8, *cfg.block_shape), dtype=torch.int32)
    inward = torch.zeros((3, *cfg.block_shape))
    dirs = cells.neighbor_offsets(3)
    for k, dvec in enumerate(dirs):
        blk = (2 * (k % 4), 2 * ((k // 4) % 4), 2 * (k // 16))
        lb = [float(torch.tensor(2 * b * w - h, dtype=torch.float32))
              for b in blk]
        x = []
        for a in range(3):
            if dvec[a] < 0:
                x.append(_f32_step(lb[a], -outside))
            elif dvec[a] > 0:
                top = float(torch.tensor(lb[a] + w, dtype=torch.float32))
                x.append(_f32_step(_f32_step(top, -1), outside))
            else:
                x.append(lb[a] + w / 2)
        norm = math.sqrt(sum(v * v for v in dvec))
        y = [x[a] + 2.5 / scale * dvec[a] / norm for a in range(3)]
        y = [_f32_step(y[a], ulps * dvec[a]) if dvec[a] else y[a]
             for a in range(3)]
        occ[(0, *blk)] = 1
        pos[(0, slice(0, 3), 0, *blk)] = torch.tensor(x)
        inward[(slice(None), *blk)] = torch.tensor([-v / norm for v in dvec])
        ncell = [2 * b + v for b, v in zip(blk, dvec)]
        color = sum((c % 2) << a for a, c in enumerate(ncell))
        nblk = tuple(c // 2 for c in ncell)
        nblk = tuple(c % cfg.half_cps for c in nblk)
        y = [v + cfg.box_length if c < 0 else v for v, c in zip(y, ncell)]
        slot = int(occ[(color, *nblk)])
        occ[(color, *nblk)] += 1
        pos[(color, slice(0, 3), slot, *nblk)] = torch.tensor(y)
    if model == "lj":
        pot = mt.LennardJones(r_cut=2.5)
    else:
        pot = mt.LJMixture(
            epsilon=((1.0, 1.5), (1.5, 0.5)), sigma=((1.0, 0.8), (0.8, 0.88)),
            r_cut_table=((2.5, 2.0), (2.0, 2.2)), shift=False)
    st = mt.SimState(pos=pos.to(device), occ=occ.to(device), sweep=0,
                     overflow=torch.zeros((), dtype=torch.bool, device=device))
    return cfg, pot, st, inward.to(device)


@pytest.mark.parametrize("model", ["lj", "ka"])
@pytest.mark.parametrize("ulps,outside", [(u, o) for u in (-4, -3, -2, -1, 1,
                                                            2, 3, 4)
                                          for o in (0, 2)])
def test_energetic_kernels_at_the_cutoff_edge(cuda, model, ulps, outside):
    """Frozen slots 1-4 float32 ulps inside and outside r_cut of an own
    slot on each face, edge and corner of its cell (the own slot on the
    cell's bound or ``outside`` ulps beyond it), moved inward by 0.01 and
    always accepted: the kernel's per-cell dE (which holds the cached
    energy at the start, a term near r_cut that culling must keep) equals
    the plain version's within 1e-5 relative + 1e-4."""
    cfg, pot, st, inward = _edge_state(model, ulps, outside, cuda)
    bs = cfg.block_shape
    perm = torch.arange(8, dtype=torch.int32, device=cuda)
    pick_u = torch.zeros((1, *bs), device=cuda)
    disp = (0.01 * inward)[None].contiguous()
    acc_u = torch.zeros((1, *bs), device=cuda)
    rec = {}
    plain = (cuda_substep.color_substep if model == "lj"
             else mixture.color_substep_mixture)
    own, de, acc, _ = plain(cfg, pot, 0, st.pos, st.occ, pick_u, disp, acc_u,
                            rec)
    de_map = torch.empty(bs, device=cuda)
    acc_map = torch.empty(bs, dtype=torch.int32, device=cuda)
    launch = (cuda_substep.launch_lj_kernel if model == "lj"
              else cuda_substep.launch_mix_kernel)
    launch(cfg, pot, st.pos, st.occ, perm, 0, pick_u, disp, acc_u, de_map,
           acc_map)
    torch.cuda.synchronize()
    assert int(acc_map.sum()) == int(acc) == 26
    assert torch.equal(st.pos[0].view(torch.int32), own.view(torch.int32))
    gap = (de_map - rec["de_cell"]).abs()
    assert bool((gap <= 1e-5 * rec["de_cell"].abs() + 1e-4).all())


@pytest.mark.parametrize("model", ["lj", "ka"])
@pytest.mark.parametrize("ulps,outside", [(u, o) for u in (-4, -1, 1, 4)
                                          for o in (0, 2)])
@pytest.mark.parametrize("scale", [0.985, 1.03])
def test_energetic_npt_kernels_at_the_cutoff_edge(cuda, model, ulps, outside,
                                                  scale):
    """``test_energetic_kernels_at_the_cutoff_edge`` for the NPT forms:
    frozen slots 1-4 float32 ulps in and out of the stored-frame cutoff
    r_cut / s (s = 0.985 keeps s w = 2.51 above r_cut); the kernel, whose
    reach is its own division by s^2, meets the plain version at s in the
    per-cell dE (within 1e-5 relative + 1e-4) and the positions."""
    cfg, pot, st, inward = _edge_state(model, ulps, outside, cuda, scale)
    bs = cfg.block_shape
    perm = torch.arange(8, dtype=torch.int32, device=cuda)
    pick_u = torch.zeros((1, *bs), device=cuda)
    disp = (0.01 * inward)[None].contiguous()
    acc_u = torch.zeros((1, *bs), device=cuda)
    s = torch.tensor(scale, device=cuda)
    rec = {}
    plain = (cuda_substep.color_substep if model == "lj"
             else mixture.color_substep_mixture)
    own, de, acc, _ = plain(cfg, pot, 0, st.pos, st.occ, pick_u, disp, acc_u,
                            rec, scale=s)
    de_map = torch.empty(bs, device=cuda)
    acc_map = torch.empty(bs, dtype=torch.int32, device=cuda)
    launch = (cuda_substep.launch_lj_kernel if model == "lj"
              else cuda_substep.launch_mix_kernel)
    launch(cfg, pot, st.pos, st.occ, perm, 0, pick_u, disp, acc_u, de_map,
           acc_map, cuda_substep.scale_squared(s, torch.float32, cuda))
    torch.cuda.synchronize()
    assert int(acc_map.sum()) == int(acc) == 26
    assert torch.equal(st.pos[0].view(torch.int32), own.view(torch.int32))
    gap = (de_map - rec["de_cell"]).abs()
    assert bool((gap <= 1e-5 * rec["de_cell"].abs() + 1e-4).all())


# ---- the field forms -------------------------------------------------------

def _fields():
    from mcjax_torch.models import fields
    return fields


def _field_cases(dim, box, species=False):
    """Fields a field-form test runs under: walls alone, walls with
    gravity on the same axis, and a trap (with per-species couplings for
    a mixture). The walls sit 1.25 inside the faces of the last axis."""
    f = _fields()
    lo, hi = -box / 2 + 1.25, box / 2 - 1.25
    walls = (f.SlitWalls(lo=lo, hi=hi, axis=dim - 1, diameters=(1.0, 0.8))
             if species else
             f.SlitWalls(lo=lo, hi=hi, axis=dim - 1, diameter=1.0))
    gravity = (f.SpeciesField(f.LinearField(g=1.0, axis=dim - 1), (0.3, 0.1))
               if species else f.LinearField(g=0.3, axis=dim - 1))
    trap = f.HarmonicTrap(stiffness=0.05, dim=dim)
    if species:
        trap = f.SpeciesField(trap, (1.0, 2.0))
    return {"walls": f.CompositeField((walls,)),
            "walls_gravity": f.CompositeField((gravity, walls)),
            "trap": trap}


def _origin(cfg, device, where):
    """Frame origin 0, near +-L/2 on every axis, or placing the physical
    seam in the middle of a cell on every axis (``seam``)."""
    if where == "zero":
        return torch.zeros(cfg.dim, device=device)
    if where == "edge":
        e = cfg.box_length / 2 - 1e-3
        return torch.tensor([e * (-1) ** a for a in range(cfg.dim)],
                            device=device)
    return torch.full((cfg.dim,), 0.5 * cfg.cell_width, device=device)


@pytest.mark.parametrize("case", [(4096, 7), "full"])
@pytest.mark.parametrize("kind", ["walls", "walls_gravity", "trap"])
@pytest.mark.parametrize("where", ["zero", "edge", "seam"])
def test_disk_field_form_matches_plain(cuda, case, kind, where):
    """The 2D kernel's field form against the plain sub-step under the same
    field: walls alone as one launch of the sweep's four sub-steps, bit for
    bit (positions and counts); an energetic field (the energetic-over-
    hard-core form) as one launch of the four sub-steps and sub-step by
    sub-step, bit for bit outside cells where a decision came within a
    relative 1e-5 of a tie, dE within 1e-5 relative + 1e-4. Every launch
    is the field form; in the ``full`` case the overflow pass runs
    (counted)."""
    cfg, pot, st, rnd = _disk_case(case, cuda)
    field = _field_cases(2, cfg.box_length)[kind]
    origin = _origin(cfg, cuda, where)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, field.has_energy)
             for i in range(cfg.n_colors)]
    stats = cuda_substep.kernel_stats(cuda)
    stats.zero_()
    lib = cuda_substep.LIB_FIELD
    before = (lib.launches, lib.field_launches)
    if not field.has_energy:
        plain = st.pos.clone()
        acc, prop = [], []
        for i, draw in enumerate(draws):
            color = int(perm[i])
            own, de, a, p = cuda_substep.color_substep(
                cfg, pot, color, plain, st.occ, *draw, field=field,
                origin=origin)
            plain[color] = own
            acc.append(int(a))
            prop.append(int(p))
        de, k_acc, k_prop = cuda_substep.substeps(
            cfg, pot, st.pos, st.occ, perm, draws, field=field,
            origin=origin)
        torch.cuda.synchronize()
        assert torch.equal(st.pos.view(torch.int32), plain.view(torch.int32))
        assert k_acc.tolist() == acc and k_prop.tolist() == prop
        assert de.tolist() == [0.0] * 4
        n_launch = 1
    else:
        # as a sweep launches it: the four sub-steps in one launch, each
        # reading its own acceptance uniforms; sub-step j's input is the
        # start with the colors of sub-steps 0..j-1 from the launch's output
        start = st.pos.clone()
        swept = st.pos.clone()
        k_de, k_acc, k_prop = cuda_substep.substeps(
            cfg, pot, swept, st.occ, perm, draws, field=field, origin=origin)
        torch.cuda.synchronize()
        inp = start.clone()
        for i, draw in enumerate(draws):
            color = int(perm[i])
            rec = {}
            own, de, a, p = cuda_substep.color_substep(
                cfg, pot, color, inp, st.occ, *draw, rec, field=field,
                origin=origin)
            differs = (swept[color].view(torch.int32)
                       != own.view(torch.int32)).any(0).any(0)
            assert not bool((differs & (rec["margin"] > 1e-5)).any())
            assert int(k_prop[i]) == int(p)
            if not bool(differs.any()):
                assert int(k_acc[i]) == int(a)
                assert abs(float(k_de[i]) - float(de)) <= \
                    1e-5 * abs(float(de)) + 1e-4
            inp[color] = swept[color]
        # and sub-step by sub-step
        for i, draw in enumerate(draws):
            color = int(perm[i])
            rec = {}
            own, de, a, p = cuda_substep.color_substep(
                cfg, pot, color, st.pos, st.occ, *draw, rec, field=field,
                origin=origin)
            k_de, k_acc, k_prop = cuda_substep.substep(
                cfg, pot, st.pos, st.occ, perm, i, *draw, field=field,
                origin=origin)
            torch.cuda.synchronize()
            differs = (st.pos[color].view(torch.int32)
                       != own.view(torch.int32)).any(0).any(0)
            assert not bool((differs & (rec["margin"] > 1e-5)).any())
            assert int(k_prop) == int(p)
            if not bool(differs.any()):
                assert int(k_acc) == int(a)
                assert abs(float(k_de) - float(de)) <= \
                    1e-5 * abs(float(de)) + 1e-4
        n_launch = 5
    assert (lib.launches, lib.field_launches) == (before[0] + n_launch,
                                                  before[1] + n_launch)
    assert (int(stats[0]) > 0) == (case == "full")


def _field_energetic_matches_plain(cuda, model, layout, field, origin_at):
    """``_energetic_kernel_matches_plain`` for the field forms: all 8
    colors under ``field`` at the frame origin ``origin_at``. Returns the
    kernels' counters over the 8 sub-steps."""
    cfg, pot, st, warm = _energetic_case((model, layout), cuda)
    lib = cuda_substep.LIB_LJ if model == "lj" else cuda_substep.LIB_MIX
    plain = (cuda_substep.color_substep if model == "lj"
             else mixture.color_substep_mixture)
    rnd = TorchRandoms(torch.Generator(cuda).manual_seed(cfg.n_atoms + 7))
    if warm:
        st, _ = mt.run_sweeps(cfg, pot, st, warm, rnd)
    origin = _origin(cfg, cuda, origin_at)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    stats = cuda_substep.kernel_stats(cuda)
    stats.zero_()
    for i in range(cfg.n_colors):
        draw = rnd.substep(cfg, st.sweep, i, True)
        color = int(perm[i])
        rec = {}
        own, de, acc, prop = plain(cfg, pot, color, st.pos, st.occ, *draw,
                                   rec, field=field, origin=origin)
        before = (lib.launches, lib.field_launches)
        k_de, k_acc, k_prop = cuda_substep.substep(
            cfg, pot, st.pos, st.occ, perm, i, *draw, field=field,
            origin=origin)
        torch.cuda.synchronize()
        assert (lib.launches, lib.field_launches) == (before[0] + 1,
                                                      before[1] + 1)
        differs = (st.pos[color].view(torch.int32)
                   != own.view(torch.int32)).any(dim=0).any(dim=0)
        assert not bool((differs & (rec["margin"] > 1e-5)).any())
        assert int(k_prop) == int(prop)
        if not bool(differs.any()):
            assert int(k_acc) == int(acc)
            assert abs(float(k_de) - float(de)) <= 1e-5 * abs(float(de)) + 1e-4
    return stats.tolist()


@pytest.mark.parametrize("model,layout", [("lj", (4000, 24)), ("lj", "full"),
                                          ("ka", (4500, 34)), ("ka", "full")])
@pytest.mark.parametrize("kind", ["walls", "walls_gravity", "trap"])
@pytest.mark.parametrize("where", ["zero", "edge", "seam"])
def test_energetic_field_forms_match_plain(cuda, model, layout, kind, where):
    """The LJ and mixture kernels' field forms against their plain
    versions (the mixture's field species-resolved) for all 8 colors, at
    origin 0, near +-L/2 and with the physical seam mid-cell; in the
    ``full`` layout the frozen slots overflow the shared memory and the
    counted pass runs."""
    box = {"lj": 4000, "ka": 4500}
    if layout == "full":
        box_l = 6 * 2.55
    else:
        rho = 0.8 if model == "lj" else 1.2
        box_l = (box[model] / rho) ** (1 / 3)
    field = _field_cases(3, box_l, species=model == "ka")[kind]
    counts = _field_energetic_matches_plain(cuda, model, layout, field, where)
    assert counts[1] > 0
    if layout == "full":
        assert counts[0] > 0


@pytest.mark.parametrize("model", ["disks", "lj", "ka"])
@pytest.mark.parametrize("ulps", [-4, -3, -2, -1, 1, 2, 3, 4])
def test_field_forms_at_the_wall_edge(cuda, model, ulps):
    """Centers on the walls' bounds moved by ``ulps`` steps of the
    physical coordinate's float32 grid (the wrap's: x + L/2 is rounded, so
    a step is a few ulps of the bound; in the mixture each species on its
    own bound), one a cell column on each wall, so the upper row lies
    beyond hi for positive ulps and the lower beyond lo for negative
    ones; every move has zero displacement (and a zero acceptance uniform),
    so the field's forbidden test alone decides it: half the centers lie
    beyond their bound. Kernel and plain version take the same moves, bit
    for bit."""
    f = _fields()
    if model == "disks":
        cfg, pot = _cfg(4096, 7), mt.HardSphere(1.0)
    elif model == "lj":
        cfg, pot, _ = bench.build_lj3d(4000, 24, 16, device="cpu")
    else:
        cfg, pot, _ = bench.build_ka3d(4500, 34, 16, device="cpu")
    dim, axis = cfg.dim, cfg.dim - 1
    w, box = cfg.cell_width, cfg.box_length
    walls = f.SlitWalls(lo=-box / 4, hi=box / 4, axis=axis, diameter=1.0,
                        diameters=(1.0, 0.8) if model == "ka" else ())
    field = f.CompositeField((walls,))
    # one center a column of cells, at its cell's middle on the other axes
    cps = cfg.cells_per_side
    grid = torch.stack(torch.meshgrid(*[torch.arange(cps)] * (dim - 1),
                                      indexing="ij"), -1).reshape(-1, dim - 1)
    other = (grid + 0.5) * w - box / 2
    n_col = other.shape[0]
    spec = (torch.arange(2 * n_col) % 2).float()
    lo, hi = walls.bounds(torch.zeros(dim, 2 * n_col),
                          spec if model == "ka" else None)
    # the physical coordinate is wrap(x) = ((x + L/2) mod L) - L/2, on the
    # float32 grid of x + L/2: step the centers along that grid
    half = torch.tensor(box / 2)
    edge = torch.cat([hi.expand(2 * n_col)[:n_col],
                      lo.expand(2 * n_col)[n_col:]]) + half
    toward = torch.full_like(edge, math.inf if ulps > 0 else -math.inf)
    for _ in range(abs(ulps)):
        edge = torch.nextafter(edge, toward)
    edge = edge - half
    x = torch.cat([torch.cat([other, other]), edge[:, None]], dim=1)
    cfg = cfg.replace(n_atoms=2 * n_col)
    if model == "ka":
        st = mixture.init_mixture_state(cfg, x, spec.int(), cuda)
    else:
        st = mt.init_state(cfg, cuda, x)
    origin = torch.zeros(dim, device=cuda)
    perm = torch.arange(cfg.n_colors, dtype=torch.int32, device=cuda)
    bs = cfg.block_shape
    plain = (mixture.color_substep_mixture if model == "ka"
             else cuda_substep.color_substep)
    accepted = 0
    for i in range(cfg.n_colors):
        pick_u = torch.rand((cfg.n_moves, *bs), device=cuda)
        disp = torch.zeros((cfg.n_moves, dim, *bs), device=cuda)
        acc_u = None if model == "disks" else torch.zeros_like(pick_u)
        own, _, acc, prop = plain(cfg, pot, i, st.pos, st.occ, pick_u, disp,
                                  acc_u, field=field, origin=origin)
        _, k_acc, k_prop = cuda_substep.substep(
            cfg, pot, st.pos, st.occ, perm, i, pick_u, disp, acc_u,
            field=field, origin=origin)
        torch.cuda.synchronize()
        assert torch.equal(st.pos[i].view(torch.int32),
                           own.view(torch.int32))
        assert (int(k_acc), int(k_prop)) == (int(acc), int(prop))
        accepted += int(acc)
    # half the centers are beyond their bound, the other half inside it
    assert 0 < accepted < cfg.n_moves * cfg.n_atoms


# The Philox forms: each held to its host-random twin fed the same draws,
# materialized by PhiloxRandoms.substep on the card (the twin is held to
# the plain version above). Their arithmetic after the draws is the
# twin's, so they agree bit for bit.

def _philox():
    from mcjax_torch.ops.random import PhiloxRandoms
    return PhiloxRandoms


@pytest.mark.parametrize("case,proposal,ih_k",
                         [((4096, 7), "uniform", 12),
                          ("sparse", "uniform", 12), ("full", "uniform", 12),
                          ((4096, 7), "gaussian", 2),
                          ((4096, 7), "gaussian", 8),
                          ((1000, 5), "gaussian", 12),
                          ((4096, 12), "gaussian", 64)])
def test_disk_philox_form_matches_twin(cuda, case, proposal, ih_k):
    """The 2D kernel's Philox form, one launch of a sweep's four sub-steps,
    against the host-random kernel fed the same draws and against the
    plain CPU path under the same key: pos, occ and counts bit for bit. In
    the ``full`` case the overflow pass runs (counted)."""
    cfg, pot, st, _ = _disk_case(case, cuda)
    cfg = cfg.replace(proposal=proposal, step_size=0.1)
    rnd = _philox()(cfg.n_atoms + ih_k, cuda, ih_k)
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    key = rnd.kernel_key(st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, False)
             for i in range(cfg.n_colors)]
    twin, occ = st.pos.clone(), st.occ.clone()
    _, t_acc, t_prop = cuda_substep.substeps(cfg, pot, twin, st.occ, perm,
                                             draws)
    cpu = st.pos.cpu()
    _, c_acc, c_prop = cuda_substep.substeps(cfg, pot, cpu, st.occ.cpu(),
                                             perm.cpu(), key)
    stats = cuda_substep.kernel_stats(cuda)
    stats.zero_()
    lib = cuda_substep.LIB_PHILOX
    before = (lib.launches, lib.philox_launches)
    _, k_acc, k_prop = cuda_substep.substeps(cfg, pot, st.pos, st.occ, perm,
                                             key)
    torch.cuda.synchronize()
    assert (lib.launches, lib.philox_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(st.pos.view(torch.int32), twin.view(torch.int32))
    assert torch.equal(st.pos.cpu().view(torch.int32), cpu.view(torch.int32))
    assert torch.equal(st.occ, occ)
    assert k_acc.tolist() == t_acc.tolist() == c_acc.tolist()
    assert k_prop.tolist() == t_prop.tolist() == c_prop.tolist()
    assert 0 < int(k_acc.sum()) < int(k_prop.sum())
    assert (int(stats[0]) > 0) == (case == "full")


@pytest.mark.parametrize("model,layout,ih_k",
                         [("lj", (4000, 24), 8), ("lj", "sparse", 8),
                          ("lj", "full", 8), ("lj", (3000, 16), 2),
                          ("lj", (4000, 24), 12), ("lj", (4000, 24), 64),
                          ("ka", (4500, 34), 8), ("ka", "sparse", 8),
                          ("ka", "full", 8), ("ka", (2800, 64), 2),
                          ("ka", (4500, 34), 64)])
def test_energetic_philox_forms_match_twin(cuda, model, layout, ih_k):
    """The LJ and mixture kernels' Philox forms for all 8 colors of a sweep
    against their host-random twins fed the same draws, bit for bit:
    positions, the per-sub-step dE, accepted and proposed counts. In the
    ``full`` layout the frozen slots overflow the shared memory and the
    counted pass runs."""
    cfg, pot, st, warm = _energetic_case((model, layout), cuda)
    lib = cuda_substep.LIB_LJ if model == "lj" else cuda_substep.LIB_MIX
    rnd = _philox()(cfg.n_atoms + ih_k, cuda, ih_k)
    if warm:
        st, _ = mt.run_sweeps(cfg, pot, st, warm, rnd)  # leave the start
    perm, _, _ = rnd.schedule(cfg, st.sweep)
    draws = [rnd.substep(cfg, st.sweep, i, True)
             for i in range(cfg.n_colors)]
    twin = st.pos.clone()
    t_de, t_acc, t_prop = cuda_substep.substeps(cfg, pot, twin, st.occ, perm,
                                                draws)
    stats = cuda_substep.kernel_stats(cuda)
    stats.zero_()
    before = (lib.launches, lib.philox_launches)
    k_de, k_acc, k_prop = cuda_substep.substeps(
        cfg, pot, st.pos, st.occ, perm, rnd.kernel_key(st.sweep))
    torch.cuda.synchronize()
    assert (lib.launches, lib.philox_launches) == (before[0] + 8,
                                                   before[1] + 8)
    assert torch.equal(st.pos.view(torch.int32), twin.view(torch.int32))
    assert torch.equal(k_de.view(torch.int32), t_de.view(torch.int32))
    assert torch.equal(k_acc, t_acc) and torch.equal(k_prop, t_prop)
    assert int(k_acc.sum()) > 0
    if layout == "full":
        assert int(stats[0]) > 0


def test_philox_words_kernel_matches_plain(cuda):
    from mcjax_torch.ops.random import philox4x32
    g = torch.Generator(cuda).manual_seed(2)
    ctr = torch.randint(0, 1 << 32, (4, 1 << 20), generator=g, device=cuda,
                        dtype=torch.int64)
    for key in [(0, 0), (0xFFFFFFFF, 0x12345678), (0xA4093822, 0x299F31D0)]:
        assert torch.equal(cuda_substep.philox_words(ctr, key),
                           philox4x32(ctr, key))
    kat = torch.tensor([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
                       dtype=torch.int64, device=cuda).reshape(4, 1)
    assert cuda_substep.philox_words(kat, (0xa4093822, 0x299f31d0))[:, 0] \
        .tolist() == [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


@pytest.mark.parametrize("model", ["disks", "lj", "ka"])
def test_philox_key_raises_under_a_field_or_a_scale(cuda, model):
    """No Philox form takes a field (ROADMAP B3) or an NPT scale: on CUDA
    the key raises rather than materialize the draws."""
    if model == "disks":
        cfg, pot, st, _ = _disk_case((1000, 5), cuda)
    else:
        cfg, pot, st, _ = _energetic_case((model, (4000, 24) if model == "lj"
                                           else (4500, 34)), cuda)
    rnd = _philox()(1, cuda, 8)
    perm, _, _ = rnd.schedule(cfg, 0)
    key = rnd.kernel_key(0)
    walls = _field_cases(cfg.dim, cfg.box_length, model == "ka")["walls"]
    with pytest.raises(NotImplementedError, match="B3"):
        cuda_substep.substeps(cfg, pot, st.pos, st.occ, perm, key,
                              field=walls)
    with pytest.raises(NotImplementedError, match="NPT"):
        cuda_substep.substeps(cfg, pot, st.pos, st.occ, perm, key,
                              scale=torch.tensor(1.0, device=cuda))
