"""Per-phase cost attribution for the binary jnp decode pipeline on device.

Attributes cost by differential timing (each timing ends in
``block_until_ready``):

  * iteration scaling   — flooding decode at 2 vs 12 iterations with
                          early_stop off: slope = pure per-iteration cost,
                          intercept = fixed dispatch + epilogue.
  * check ablation      — check='none' vs 'zero' vs 'syndrome' at equal
                          iterations: the early-stop check's per-iteration
                          price.
  * channel generation  — the jitted AWGN draw alone.
  * VN vs CN            — VN-only vs a full iteration, as separate jitted
                          computations.

Optionally wraps one decode call in ``jax.profiler.trace`` (--trace DIR) —
the sweep drivers expose the same via ``--profile DIR`` (one traced batch
per SNR point).

Usage: python tools/profile_phases.py [--code J15_L30_Z1280] [--batch 4096]
                                      [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _timeit(fn, *args, reps=3):
    import jax
    jax.block_until_ready(fn(*args))      # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="J15_L30_Z1280")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snr", type=float, default=2.2)
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import functools

    import jax
    import jax.numpy as jnp

    from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
    from cuda_ldpc_tpu.ops import channel, minsum

    code = QCBinaryCode.from_registry(args.code)
    sigma = channel.sigma_from_snr(args.snr, code.rate, "ebn0")
    B = args.batch

    chan_fn = jax.jit(lambda k: 1.0 + sigma * jax.random.normal(
        k, (B, code.L, code.Z), dtype=jnp.float32))
    chan = jax.block_until_ready(chan_fn(jax.random.PRNGKey(0)))
    rows = {"device": jax.devices()[0].device_kind}
    rows["channel_gen_s"] = _timeit(chan_fn, jax.random.PRNGKey(1))

    def dec(n, check):
        return jax.jit(functools.partial(
            minsum.decode_flooding, code=code, num_iters=n, check=check,
            early_stop=False))

    t2 = _timeit(dec(2, "none"), chan)
    t12 = _timeit(dec(12, "none"), chan)
    per_iter = (t12 - t2) / 10
    rows["per_iter_s"] = per_iter
    rows["fixed_s"] = t2 - 2 * per_iter
    for check in ("zero", "syndrome"):
        tc = _timeit(dec(12, check), chan)
        rows[f"check_{check}_per_iter_s"] = (tc - t12) / 12

    R0 = jnp.zeros((B, code.num_edges, code.Z), jnp.float32)
    vn = jax.jit(lambda c, R: minsum._vn_update(code, c, R)[0])

    def full_iter(c, R):
        total, hard, Q = minsum._vn_update(code, c, R)
        newR = [None] * code.num_edges
        for j in range(code.J):
            Rr = minsum._cn_minsum(minsum._row_stack(code, Q, j), 1.0, 0.0)
            for i, e in enumerate(code.row_edges[j]):
                newR[e] = jnp.roll(Rr[:, i], int(code.edges[e, 2]), axis=-1)
        return jnp.stack(newR, axis=1)

    fi = jax.jit(full_iter)
    tv = _timeit(vn, chan, R0)
    tf = _timeit(fi, chan, R0)
    rows["vn_s"] = tv
    rows["cn_s"] = tf - tv

    if args.trace:
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(dec(12, "zero")(chan))
        rows["trace_dir"] = args.trace

    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
