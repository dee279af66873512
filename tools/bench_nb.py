"""NB decoder throughput benchmark.

Two modes:

  methods  — per-method sustained decode throughput: ``reps`` decode calls
             dispatched back to back, timed to ``block_until_ready``.
             Frames/s, avg iterations, FER at the operating point.
  engine   — end-to-end sweep throughput of the batch engine vs the
             continuous-batching stream engine at one SNR point, through
             the production driver (sim.run_nb_sweep), reporting each
             engine's steady-state frames/s and FER.

The reference decodes ONE frame at a time on the GPU with <=96x4 CUDA
threads (myNBLDPC/src/Decode_GPU.cu:222) and reports sec/frame per row
(myNBLDPC/src/Simulation.cpp:198); these tables are the batched
counterpart.

Usage:
  python tools/bench_nb.py methods [--code BDS.576.288.GF.64] [--snr 2.0]
         [--batch 1024] [--max-iters 20] [--reps 6] [--methods a,b,...]
  python tools/bench_nb.py engine [--snr 2.0] [--batch 1024] ...
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def bench_methods(args) -> list[dict]:
    import jax
    import numpy as np

    from cuda_ldpc_tpu import NBCode
    from cuda_ldpc_tpu.ops import channel, demod, nb_decode
    from cuda_ldpc_tpu.utils.constellations import constellation

    code = NBCode.from_registry(args.code)
    sigma = channel.sigma_from_snr(args.snr, code.rate, "ebn0", 1.0)
    tx = np.zeros(code.bit_length, dtype=np.int64)
    points = constellation(2)
    B = args.batch

    # Distinct noise buffers per rep (bounded set, like bench.py): JAX does
    # not memoize executions, so reuse does not skew timing.
    n_bufs = min(args.reps, 4)
    llr = jax.jit(lambda k: demod.nb_channel_llr(k, tx, points, sigma,
                                                 batch=B, q=code.q))
    bufs = jax.block_until_ready(
        [llr(jax.random.PRNGKey(1000 + i)) for i in range(n_bufs)])

    methods = (args.methods.split(",") if args.methods
               else list(nb_decode.METHODS))
    out = []
    for method in methods:
        import jax.numpy as jnp

        def run(L, method=method):
            r = nb_decode.decode(L, code, method, args.max_iters,
                                 nm=args.nm, nc=args.nc)
            return jnp.stack([jnp.sum(jnp.any(r.hard != 0, axis=1)
                                      .astype(jnp.int32)),
                              jnp.sum(r.iters)])
        dec = jax.jit(run)
        jax.block_until_ready(dec(bufs[0]))     # compile + warm
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            [dec(bufs[i % n_bufs]) for i in range(args.reps)])
        dt = time.perf_counter() - t0
        errs = sum(int(np.asarray(o)[0]) for o in outs)
        its = sum(int(np.asarray(o)[1]) for o in outs)
        row = {
            "method": method, "code": args.code, "snr_db": args.snr,
            "batch": B, "max_iters": args.max_iters,
            "frames_per_s": round(args.reps * B / dt, 1),
            "avg_iters": round(its / (args.reps * B), 2),
            "fer": round(errs / (args.reps * B), 6),
        }
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def bench_engine(args) -> list[dict]:
    from cuda_ldpc_tpu import config as cfg, sim

    out = []
    for engine in ("batch", "stream"):
        c = cfg.NBSimConfig(
            code=args.code,
            decoder=cfg.NBDecoderConfig(method=args.method,
                                        max_iters=args.max_iters,
                                        nm=args.nm, nc=args.nc),
            sweep=cfg.SweepConfig(
                snr_start=args.snr, snr_step=1.0, snr_stop=args.snr,
                least_error_frames=args.errors,
                least_test_frames=args.frames, max_frames=args.max_frames),
            batch_per_device=args.batch,
            engine=engine, stream_steps=args.stream_steps)
        res = sim.run_nb_sweep(c, quiet=True)
        r = res.rows[0]
        timed = r.get("timed_frames") or r["frames"]
        row = {
            "engine": engine,
            "method": args.method, "code": args.code,
            "snr_db": args.snr, "batch": args.batch,
            "frames": r["frames"], "fer": r["fer"],
            "avg_iters": round(r["avg_iters"], 2),
            "frames_per_s": round(timed / r["decode_s"], 1)
            if r["decode_s"] else None,
        }
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    pm = sub.add_parser("methods")
    pm.add_argument("--code", default="BDS.576.288.GF.64")
    pm.add_argument("--snr", type=float, default=2.0)
    pm.add_argument("--batch", type=int, default=1024)
    pm.add_argument("--max-iters", type=int, default=20)
    pm.add_argument("--nm", type=int, default=2)
    pm.add_argument("--nc", type=int, default=2)
    pm.add_argument("--reps", type=int, default=6)
    pm.add_argument("--methods", default="")
    pe = sub.add_parser("engine")
    pe.add_argument("--code", default="BDS.576.288.GF.64")
    pe.add_argument("--method", default="layered_qspa")
    pe.add_argument("--snr", type=float, default=2.0)
    pe.add_argument("--batch", type=int, default=1024)
    pe.add_argument("--max-iters", type=int, default=20)
    pe.add_argument("--nm", type=int, default=2)
    pe.add_argument("--nc", type=int, default=2)
    pe.add_argument("--stream-steps", type=int, default=16)
    pe.add_argument("--errors", type=int, default=200)
    pe.add_argument("--frames", type=int, default=50_000)
    pe.add_argument("--max-frames", type=int, default=300_000)
    args = ap.parse_args()
    if args.mode == "methods":
        bench_methods(args)
    else:
        bench_engine(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
