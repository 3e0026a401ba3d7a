"""The contact-shell observables of the RNG gate against mcjax's, on the CPU.

``mcjax_torch.utils.observables.contact_shell_gr_cells`` and
``hard_disk_eos_state`` against ``mcjax.utils.observables``' on one
state of 1,024 hard disks (the port's plain path, 5 sweeps from the
lattice at phi 0.5), and the one-ring coverage check of both.

Tolerances: the histogram counts pairs (halves) in float32 bins whose
edges both compute in float32 from the same squared distances, so g is
held to 1e-6 relative (the normalisation's rounding); Z, a polynomial
fit of g, to 1e-6 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcjax.core.config import SimConfig as JaxConfig
from mcjax.utils import observables as jobs

from mcjax_torch import bench
from mcjax_torch.ops.random import PhiloxRandoms
from mcjax_torch.ops.sweep import run_sweeps
from mcjax_torch.utils import observables

REL = 1e-6


@pytest.fixture(scope="module")
def disks():
    cfg, pot, st = bench.build(1024, 0.5, 2.0, 7, 16, device="cpu")
    st, _ = run_sweeps(cfg, pot, st, 5, PhiloxRandoms(3, "cpu"))
    return cfg, st, JaxConfig(**dataclasses.asdict(cfg))


def test_contact_shell_gr_matches_mcjax(disks):
    cfg, st, jcfg = disks
    got = observables.contact_shell_gr_cells(cfg, st.pos, st.occ, 1.0, 12,
                                             0.05)
    want = np.asarray(jobs.contact_shell_gr_cells(
        jcfg, jnp.asarray(st.pos.numpy()), jnp.asarray(st.occ.numpy()), 1.0,
        12, 0.05))
    assert got.dtype == torch.float32 and got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    assert float(got.sum()) > 0


def test_hard_disk_eos_matches_mcjax(disks):
    cfg, st, jcfg = disks
    z = observables.hard_disk_eos_state(cfg, (st.pos, st.occ), 1.0)
    z_ref = jobs.hard_disk_eos_state(
        jcfg, (jnp.asarray(st.pos.numpy()), jnp.asarray(st.occ.numpy())), 1.0)
    assert abs(z - z_ref) <= REL * abs(z_ref)
    assert 2.0 < z < 12.0      # Henderson's Z at phi 0.5 is about 5.9


def test_contact_shell_coverage_check(disks):
    cfg, st, jcfg = disks
    window = cfg.cell_width           # shell out to 1 + w > w
    with pytest.raises(ValueError, match="one-ring"):
        observables.contact_shell_gr_cells(cfg, st.pos, st.occ, 1.0, 12,
                                           window)
    with pytest.raises(ValueError, match="one-ring"):
        jobs.contact_shell_gr_cells(jcfg, jnp.asarray(st.pos.numpy()),
                                    jnp.asarray(st.occ.numpy()), 1.0, 12,
                                    window)
