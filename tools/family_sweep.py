"""Sweep the full shipped BlockH code family (BASELINE.json config:
'Full BlockH family sweep ... batched multi-code FER/BER curves').

For each binary code, runs a packed multi-SNR sweep around its waterfall and
appends a table to FAMILY.md.

Usage: python tools/family_sweep.py [--fast] [--codes A,B,...]
"""

from __future__ import annotations

import argparse
import datetime
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

import jax

if os.environ.get("VALIDATE_PLATFORM"):
    jax.config.update("jax_platforms", os.environ["VALIDATE_PLATFORM"])

from cuda_ldpc_tpu import QCBinaryCode, config as cfg, sim
from cuda_ldpc_tpu.utils import registry


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--codes", default=None)
    ap.add_argument("--out", default="FAMILY.md")
    args = ap.parse_args()
    names = (args.codes.split(",") if args.codes else registry.BINARY_CODES)
    fast = args.fast

    lines = [f"# BlockH family sweep — {datetime.date.today()}, "
             f"{jax.devices()[0].device_kind} x{jax.device_count()}", "",
             "Packed multi-SNR sweeps, flooding min-sum, zero codeword, "
             "Eb/N0; stop at >=%d errors & >=%d frames." %
             ((10, 256) if fast else (50, 5000)), "",
             "| code | n | k | rate | SNR (dB) -> FER |",
             "|---|---|---|---|---|"]
    for name in names:
        code = QCBinaryCode.from_registry(name)
        # center a 5-point window on a crude rate-driven waterfall guess
        center = 1.2 + 3.2 * code.rate
        simcfg = cfg.BinarySimConfig(
            code=name,
            decoder=cfg.BinaryDecoderConfig(max_iters=30, check="zero"),
            sweep=cfg.SweepConfig(
                snr_start=round(center - 0.8, 2), snr_step=0.4,
                snr_stop=round(center + 0.8, 2), snr_type="ebn0",
                least_error_frames=10 if fast else 50,
                least_test_frames=256 if fast else 5000,
                max_frames=2048 if fast else 200_000, display_step=10**9),
            # large batches amortize the per-call dispatch cost; small
            # codes get more frames per call
            batch_per_device=32 if fast else max(
                2048, 2048 * (38400 // code.n)))
        res = sim.run_binary_sweep_packed(simcfg, quiet=True)
        curve = ", ".join(f"{r['snr']:g}->{r['fer']:.1e}" for r in res.rows)
        lines.append(f"| {name} | {code.n} | {code.k} | {code.rate:.3f} "
                     f"| {curve} |")
        print(name, curve, flush=True)
    pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
