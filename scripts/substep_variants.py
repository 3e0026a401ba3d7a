#!/usr/bin/env python3
"""Build variant trees of the energetic sub-step kernels, for timing.

    python3 scripts/substep_variants.py [NAME ...]

Each ``scripts/substep_variants/NAME.diff`` is a patch against this tree's
``mcjax_torch/csrc``: one design step of ``substep_lj.cu`` and
``substep_mix.cu`` taken back, or one alternative tried and not kept. For
each NAME (all by default) the script copies the tree to
``build/variants/NAME`` (``build/`` is ignored by git) and applies the
patch there with ``patch -p1``; ``scripts/time_substep_kernels.py`` run
from inside each copy then times it, in turns with this tree, in one chip
call. The patches:

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
  the kernels without their move loop, and without the frozen-cache build,
  which splits a launch's time into staging, cache and moves.
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
