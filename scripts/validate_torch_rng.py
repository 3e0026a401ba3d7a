#!/usr/bin/env python3
"""The statistical gate of the port's in-kernel (Philox) draws on one GPU:
the port of scripts/validate_in_kernel_rng.py
(``mcjax_torch.utils.rng_gate``).

    python3 scripts/validate_torch_rng.py [--ih-k 8] [--seed 0]
                                          [--json-out PATH]

Runs hard disks (262,144), 3D LJ (110,592) and Kob-Andersen (87,793) under
the kernels' Philox forms and under host draws, prints one line per check
and a summary, and exits non-zero on any failure. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mcjax_torch.utils.rng_gate import run_gate  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ih-k", type=int, default=8,
                    help="Irwin-Hall halves per gaussian component (3D)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the summary as JSON")
    args = ap.parse_args()
    res = run_gate(ih_k=args.ih_k, seed=args.seed)
    res["torch"] = torch.__version__
    res["cuda"] = torch.version.cuda
    print(f"{'PASS' if res['ok'] else 'FAIL'}  rng gate summary: ih_k="
          f"{res['ih_k']} on {res['device_name']} ({len(res['checks'])} "
          f"checks, failures={res['failures']})")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
