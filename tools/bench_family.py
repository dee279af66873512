"""Throughput sweep over the whole BlockH family through bench.py.

Runs bench.py (pipelined sustained info Mb/s, 10 fixed min-sum iterations)
for every registered binary code and prints a markdown table row per code.
Each code runs in its own bench.py process, one after another: the parent
never imports JAX, so exactly one process holds the GPU at a time.

Usage:  python tools/bench_family.py [--reps 4] [--codes A,B,...]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--codes", default=None,
                    help="comma-separated subset (default: all binary codes)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="per-code seconds, compile included")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    from cuda_ldpc_tpu.utils import registry

    codes = (args.codes.split(",") if args.codes else registry.BINARY_CODES)
    print("| code | info throughput | vs 1 Gb/s target |")
    print("|---|---|---|")
    for name in codes:
        env = dict(os.environ, BENCH_CODE=name, BENCH_REPS=str(args.reps))
        try:
            out = subprocess.run(
                [sys.executable, str(REPO / "bench.py")], env=env,
                capture_output=True, text=True, timeout=args.timeout)
            line = out.stdout.strip().splitlines()[-1]
            row = json.loads(line)
            print(f"| {name} | {row['value']:.0f} Mb/s "
                  f"| {row['vs_baseline']:.2f}x |", flush=True)
        except (subprocess.TimeoutExpired, json.JSONDecodeError,
                IndexError) as e:
            print(f"| {name} | FAILED ({type(e).__name__}) | — |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
