"""Package-level rules of the port: it imports no JAX, its entry points run
on CUDA unless told otherwise, and its wrappers refuse what they cannot run."""

import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcjax_torch as mt
from mcjax_torch.ops import cuda_shift, cuda_substep
from mcjax_torch.ops.random import TorchRandoms

ROOT = pathlib.Path(__file__).resolve().parent.parent
BOX = math.sqrt(256 * math.pi / 4 / 0.5)
CPS = int(BOX // 2) - int(BOX // 2) % 2
CFG = mt.SimConfig(dim=2, n_atoms=256, box_length=BOX,
                   cells_per_side=CPS, nmax=7, n_moves=4,
                   proposal="uniform", step_size=0.18, beta=1.0, seed=0)
POT = mt.HardSphere(1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_import_leaves_jax_out():
    """Every module of the port imports without JAX or the JAX package."""
    code = ("import importlib, pkgutil, sys, mcjax_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "mcjax_torch.__path__, 'mcjax_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert {'mcjax_torch.bench', 'mcjax_torch.ops.cuda_substep', "
            "'mcjax_torch.ops.cuda_shift', 'mcjax_torch.ops.mixture', "
            "'mcjax_torch.models.mixtures'} <= set(mods), mods; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'mcjax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_name_no_jax():
    files = [*(ROOT / "mcjax_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mcjax)\b",
                         re.MULTILINE)
    bad = [str(p) for p in files if pattern.search(p.read_text())]
    assert len(files) > 10 and not bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert mt.init_state(CFG).pos.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.init_state(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.zeros_state(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.state_from_numpy(np.zeros((4, 2, 7, 8, 8), np.float32),
                            np.zeros((4, 8, 8), np.int32), 0, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.init_mixture_state(CFG, torch.zeros((2, 2)),
                              torch.zeros(2, dtype=torch.int32))


def test_wrappers_check_their_inputs():
    st = mt.init_state(CFG, device="cpu")
    g = torch.Generator().manual_seed(0)
    perm, axis, d = TorchRandoms(g).schedule(CFG, 0)
    pick_u, disp, _ = TorchRandoms(g).substep(CFG, 0, 0, False)
    with pytest.raises(ValueError, match="perm"):
        cuda_substep.substep(CFG, POT, st.pos, st.occ, perm.long(), 0,
                             pick_u, disp)
    with pytest.raises(ValueError, match="disp"):
        cuda_substep.substep(CFG, POT, st.pos, st.occ, perm, 0, pick_u,
                             disp[:, :1].contiguous())
    with pytest.raises(ValueError, match="pos"):
        cuda_shift.shift(CFG, st.pos.transpose(3, 4), st.occ, axis, d)
    with pytest.raises(ValueError, match="d"):
        cuda_shift.shift(CFG, st.pos, st.occ, axis, d.double())


def test_substep_raises_where_no_kernel_runs():
    """On a device other than the CPU the wrapper never runs the plain
    version: a configuration no kernel covers raises before anything else
    (here on the meta device, which has no kernels at all): a capacity
    past a kernel's, or a model no kernel covers (a 2D mixture)."""
    meta = torch.device("meta")
    lj = mt.LennardJones(r_cut=1.0)
    cases = [(CFG.replace(nmax=17), lj, "nmax"),
             (CFG.replace(dim=3, cells_per_side=4, nmax=33), POT, "nmax"),
             (CFG.replace(nmax=17), POT, "nmax"),
             (CFG.replace(dim=3, cells_per_side=4, nmax=33), lj, "nmax"),
             (CFG, mt.kob_andersen(), "no CUDA sub-step kernel")]
    for cfg, pot, match in cases:
        bs = cfg.block_shape
        planes = cfg.dim + int(getattr(pot, "is_mixture", False))
        args = [torch.empty((cfg.n_colors, planes, cfg.nmax, *bs),
                            device=meta),
                torch.empty((cfg.n_colors, *bs), dtype=torch.int32,
                            device=meta),
                torch.empty((cfg.n_colors,), dtype=torch.int32, device=meta),
                0,
                torch.empty((cfg.n_moves, *bs), device=meta),
                torch.empty((cfg.n_moves, cfg.dim, *bs), device=meta),
                torch.empty((cfg.n_moves, *bs), device=meta)]
        with pytest.raises(NotImplementedError, match=match):
            cuda_substep.substep(cfg, pot, *args)
    cfg3 = CFG.replace(dim=3, cells_per_side=4, nmax=24)
    assert cuda_substep.kernel_library(cfg3, lj) is cuda_substep.LIB_LJ
    assert cuda_substep.kernel_library(CFG, POT) is cuda_substep.LIB
    st = mt.init_state(CFG, device="cpu")
    perm, _, _ = TorchRandoms(torch.Generator().manual_seed(0)).schedule(
        CFG, 0)
    pick_u, disp, _ = TorchRandoms(torch.Generator()).substep(CFG, 0, 0,
                                                              False)
    with pytest.raises(ValueError, match="acceptance"):
        cuda_substep.substep(CFG, lj, st.pos, st.occ, perm, 0, pick_u, disp)


def test_substeps_range_equals_substep_calls():
    """``substeps`` over a range that starts mid-sweep equals ``substep``
    called once per sub-step (the plain path), and refuses a range that
    leaves the sweep."""
    st = mt.init_state(CFG, device="cpu")
    rnd = TorchRandoms(torch.Generator().manual_seed(4))
    perm, _, _ = rnd.schedule(CFG, 0)
    draws = [rnd.substep(CFG, 0, i, False) for i in range(CFG.n_colors)]
    one = st.pos.clone()
    want = [cuda_substep.substep(CFG, POT, one, st.occ, perm, i, *draws[i])
            for i in range(1, CFG.n_colors)]
    de, acc, prop = cuda_substep.substeps(CFG, POT, st.pos, st.occ, perm,
                                          draws[1:], start=1)
    assert torch.equal(st.pos, one)
    assert acc.tolist() == [int(w[1]) for w in want]
    assert prop.tolist() == [int(w[2]) for w in want]
    assert de.shape == (3,) and not bool(de.any())
    with pytest.raises(ValueError, match="outside"):
        cuda_substep.substeps(CFG, POT, st.pos, st.occ, perm, draws, start=1)


def test_torch_randoms_shapes_and_seed():
    def draw(seed):
        r = TorchRandoms(torch.Generator().manual_seed(seed))
        perm, axis, d = r.schedule(CFG, 0)
        pick_u, disp, acc_u = r.substep(CFG, 0, 0, need_acc=True)
        return perm, axis, d, pick_u, disp, acc_u

    a, b = draw(3), draw(3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    perm, axis, d, pick_u, disp, acc_u = a
    assert sorted(perm.tolist()) == [0, 1, 2, 3] and perm.dtype == torch.int32
    assert axis.dtype == torch.int32 and 0 <= int(axis) < 2
    assert abs(float(d)) <= CFG.cell_width / 2
    assert pick_u.shape == acc_u.shape == (4, *CFG.block_shape)
    assert disp.shape == (4, 2, *CFG.block_shape)
    assert float(disp.abs().max()) <= CFG.step_size
    assert not torch.equal(a[3], draw(4)[3])


def test_torch_randoms_run_keeps_invariants():
    st = mt.init_state(CFG, device="cpu")
    rnd = TorchRandoms(torch.Generator().manual_seed(1))
    st, m = mt.run_sweeps(CFG, POT, st, 3, rnd)
    assert m.accepted.shape == (3,) and st.sweep == 3
    assert 0 < int(m.accepted.sum()) < int(m.proposed.sum())
    mt.validate_state(CFG, st, POT)


def test_validate_state_finds_an_overlap():
    st = mt.init_state(CFG, device="cpu")
    color, *cell = (int(i) for i in torch.nonzero(st.occ == 1)[0])
    st.pos[(color, slice(None), 1, *cell)] = st.pos[(color, slice(None), 0,
                                                     *cell)]
    st.occ[(color, *cell)] = 2
    with pytest.raises(mt.StateInvariantError, match="particle count"):
        mt.validate_state(CFG, st, POT)
    with pytest.raises(mt.StateInvariantError, match="overlap"):
        mt.validate_state(CFG, st, POT, expect_atoms=int(st.occ.sum()))


def test_validate_state_measures_contact():
    """A pair at contact passes; one pushed a float32 ulp inside is within
    the slack and reported; one pushed 0.01 inside fails."""
    ulp = float(np.spacing(np.float32(CFG.box_length / 2)))
    cfg = CFG.replace(n_atoms=2)
    for inset, ok in ((0.0, True), (ulp, True), (0.01, False)):
        r = torch.tensor([[0.3, -0.2], [0.3 + 1.0 - inset, -0.2]],
                         dtype=torch.float32)
        st = mt.init_state(cfg, device="cpu", positions=r)
        if ok:
            rep = mt.validate_state(cfg, st, POT)
            assert rep["overlap_depth_ulps"] <= 2
        else:
            with pytest.raises(mt.StateInvariantError, match="overlap"):
                mt.validate_state(cfg, st, POT)


def test_overflow_flag_is_sticky():
    """A packed start (nmax 2 at mean occupancy 2.56) overflows at binning;
    the flag stays set through sweeps, whatever the shifts report."""
    cfg = CFG.replace(nmax=2)
    st = mt.init_state(cfg, device="cpu")
    assert bool(st.overflow)
    st, m = mt.run_sweeps(cfg, POT, st, 3,
                          TorchRandoms(torch.Generator().manual_seed(2)))
    assert bool(st.overflow) and m.overflow.dtype == torch.bool
    assert int(st.occ.max()) <= 2


def test_float32_cell_edges_within_two_ulps():
    """validate_state's cell-bound slack (4 ulps of L/2) rests on this: at
    N = 2^20 the sweep's float32 cell edges (fma(c, w, -L/2) and + w) and
    the shift's float32 binning edges lie within 2 ulps of L/2 of the exact
    edges c*w - L/2."""
    from mcjax_torch.ops.cuda_substep import cell_lower_bounds

    box = math.sqrt((1 << 20) * math.pi / 2)
    cfg = CFG.replace(n_atoms=1 << 20, box_length=box, cells_per_side=640)
    h = np.float32(box / 2)
    ulp = float(np.spacing(h))
    exact = np.arange(641) * cfg.cell_width - box / 2
    lb = cell_lower_bounds(cfg, 0, cfg.block_shape, torch.device("cpu"))
    lb = lb[1, 0].double().numpy()                 # cells 0, 2, ..., 638
    hi = (lb.astype(np.float32) + np.float32(cfg.cell_width)).astype(float)
    assert np.abs(lb - exact[0:640:2]).max() < 2 * ulp
    assert np.abs(hi - exact[1:641:2]).max() < 2 * ulp
    inv_w = np.float32(1.0 / cfg.cell_width)
    worst = 0.0
    for k in range(1, 640):
        xs = np.unique((exact[k] + np.linspace(-8, 8, 1025) * ulp)
                       .astype(np.float32))
        cell = np.floor((xs + h).astype(np.float32) * inv_w)
        worst = max(worst, abs(float(xs[np.argmax(cell >= k)]) - exact[k]))
    assert worst < 2 * ulp
