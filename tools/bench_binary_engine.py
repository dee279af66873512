"""Binary batch vs stream engine end-to-end throughput at one SNR point,
through the production sweep driver (sim.run_binary_sweep) — the binary
counterpart of `bench_nb.py engine`.

The batch engine early-terminates for the whole batch at once (one
uncorrectable frame burns maxIT for every frame of its batch); the stream
engine re-seeds finished slots so throughput tracks the mean iteration
count.  Reports steady-state info Mb/s and frames/s per
engine plus FER for the parity check.

Usage:
  python tools/bench_binary_engine.py
    [--code J15_L30_Z1280] [--snr 2.2] [--batch 4096] [--max-iters 50]
    [--errors 200] [--frames 50000]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="J15_L30_Z1280")
    ap.add_argument("--snr", type=float, default=2.2)
    ap.add_argument("--snr-type", default="ebn0")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--stream-steps", type=int, default=16)
    ap.add_argument("--check", default="zero")
    ap.add_argument("--errors", type=int, default=200)
    ap.add_argument("--frames", type=int, default=50_000)
    ap.add_argument("--max-frames", type=int, default=400_000)
    ap.add_argument("--engines", default="batch,stream")
    args = ap.parse_args()

    from cuda_ldpc_tpu import config as cfg, sim

    out = []
    for engine in args.engines.split(","):
        c = cfg.BinarySimConfig(
            code=args.code,
            decoder=cfg.BinaryDecoderConfig(max_iters=args.max_iters,
                                            check=args.check),
            sweep=cfg.SweepConfig(
                snr_start=args.snr, snr_step=1.0, snr_stop=args.snr,
                snr_type=args.snr_type,
                least_error_frames=args.errors,
                least_test_frames=args.frames, max_frames=args.max_frames,
                display_step=10**9),
            batch_per_device=args.batch,
            engine=engine, stream_steps=args.stream_steps)
        res = sim.run_binary_sweep(c, quiet=True)
        r = res.rows[0]
        timed = r.get("timed_frames") or r["frames"]
        row = {
            "engine": engine, "code": args.code, "snr_db": args.snr,
            "batch": args.batch, "max_iters": args.max_iters,
            "frames": r["frames"], "fer": r["fer"],
            "avg_iters": round(r["avg_iters"], 2),
            "frames_per_s": round(timed / r["decode_s"], 1)
            if r["decode_s"] else None,
            "info_mbps": round(r["info_mbps"], 1),
        }
        out.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
