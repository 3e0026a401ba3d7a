#!/usr/bin/env python3
"""Soak the port's main path: many sweeps of the 1M hard-disk system on one
GPU, with every invariant checked along the way.

    python3 scripts/soak_torch_disks.py [--sweeps 2000] [--every 100]
                                        [--moves 64] [--seed 0]

Every ``--every`` sweeps it runs ``validate_state`` (occupancy, N, overflow,
cell bounds, in-box, overlaps) and prints one JSON line with the sweep
count, the acceptance so far, the worst slot outside its exact cell and the
deepest overlap (both in float32 ulps of L/2). Any violation raises.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mcjax_torch as mt  # noqa: E402
from mcjax_torch import bench  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=2000)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--moves", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg, pot, st = bench.build(1 << 20, 0.5, 2.0, 7, args.moves, args.seed)
    rnd = mt.TorchRandoms(torch.Generator("cuda").manual_seed(args.seed))
    accepted = proposed = 0
    worst = {"cell_excursion_ulps": 0.0, "overlap_depth_ulps": 0.0}
    while st.sweep < args.sweeps:
        st, m = mt.run_sweeps(cfg, pot, st, args.every, rnd)
        accepted += int(m.accepted.sum())
        proposed += int(m.proposed.sum())
        report = mt.validate_state(cfg, st, pot)
        worst = {k: max(worst[k], v) for k, v in report.items()}
        print(json.dumps({"sweep": st.sweep,
                          "acceptance": accepted / proposed, **report}),
              flush=True)
    print(json.dumps({"sweeps": st.sweep, "worst": worst,
                      "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
