#!/usr/bin/env python3
"""Build variant trees of the sub-step and shift kernels, for timing.

    python3 scripts/substep_variants.py [NAME ...]

Each ``scripts/substep_variants/NAME.diff`` is a patch against this tree's
``mcjax_torch/csrc``: one design step of a kernel taken back, or (for the
energetic kernels) one alternative tried and not kept. For each NAME (all
by default) the script copies the tree to ``build/variants/NAME``
(``build/`` is ignored by git) and applies the patch there with
``patch -p1``;
``scripts/time_substep_kernels.py --tree build/variants/NAME`` then times
it, in turns with this tree, in one chip call. The patches of the 2D
sub-step kernel (``substep.cu``) and the shift (``shift.cu``):

* ``k1_nocull``: no culling of frozen slots (every live neighbor slot
  staged, 56 a thread: 8 x nmax at nmax 7, so no cell takes the overflow
  pass);
* ``k1_percolor``: one launch a sub-step instead of one for the range;
* ``k1_registers``: the frozen slots in registers, the parent's form (8 x
  nmax of them, culled and empty ones parked far away, all tested every
  move; launch bounds without a minimum of blocks);
* ``shift_thread``: the shift's old thread-per-cell form (candidates read
  from device memory one at a time, outputs written at the running count);
* ``shift_fmodf``: the wrap into the box by ``fmodf`` alone, without the
  subtraction that stands for it within two box lengths.

Those of the energetic kernels (``substep_3d.cuh`` and ``pair.cuh``,
whose LJ instantiation ``substep_lj.cu`` builds, and ``substep_mix.cu``):

* ``lj_persistent``: the LJ kernel on the mixture kernel's persistent grid
  (warps take cells from a counter);
* ``mix_blocks``: the mixture kernel on one block per four cells;
* ``noprefetch``: the LJ kernel's staging reads one raw round at a time,
  not four; ``mix_prefetch``: the mixture kernel's reads four;
* ``slowrcp``: ``__frcp_rn`` itself, with its test for extreme exponents;
* ``bfly2``: two butterflies every move (the frozen part and the own
  part, interleaved), instead of one for dE and a second for the new
  cache entry only when the move is taken;
* ``ljselect``: the LJ kernel's cutoff select on candidates too;
* ``g16``: 16 lanes a cell, two cells a warp, 16 resident warps an SM
  (LJ kernel only);
* ``nomoves`` and ``nocache``, for timing only (their results are wrong):
  the kernels without their move loop, and without the frozen-cache
  build, which splits a launch's time into staging, cache and moves.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATCHES = ROOT / "scripts" / "substep_variants"


def make(name: str) -> Path:
    dest = ROOT / "build" / "variants" / name
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT, dest, ignore=shutil.ignore_patterns(
        ".git", "build", "*_out", "__pycache__"))
    subprocess.run(["patch", "-s", "-p1", "-i",
                    str(PATCHES / f"{name}.diff")], cwd=dest, check=True)
    return dest


def main() -> int:
    names = sys.argv[1:] or sorted(p.stem for p in PATCHES.glob("*.diff"))
    for name in names:
        print(make(name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
