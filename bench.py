"""Headline benchmark: decoded info Mb/s on one GPU, binary QC-LDPC
J15_L30_Z1280 (n=38400, k=19200), flooding min-sum, 10 fixed iterations
(BASELINE.json north star; baseline target 1000 Mb/s).

Runs only on a GPU: without one it exits nonzero and prints no number.
Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mb/s", "vs_baseline": N/1000,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

Environment knobs: BENCH_CODE, BENCH_BATCH (frames per call, default the
reference's Num_Frames_OneTime 4096, define.cuh:60), BENCH_ITERS,
BENCH_DTYPE (float32 | bfloat16 message storage), BENCH_SCHEDULE
(flooding | layered), BENCH_REPS, BENCH_PROFILE (trace directory).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

BASELINE_MBPS = 1000.0


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX's first device is {dev.platform!r})",
              file=sys.stderr)
        return 3

    from cuda_ldpc_tpu import QCBinaryCode
    from cuda_ldpc_tpu.ops import minsum
    from cuda_ldpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    code = QCBinaryCode.from_registry(os.environ.get("BENCH_CODE",
                                                     "J15_L30_Z1280"))
    B = int(os.environ.get("BENCH_BATCH", "4096"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    dtype = (jnp.bfloat16 if os.environ.get("BENCH_DTYPE", "float32")
             == "bfloat16" else jnp.float32)
    schedule = os.environ.get("BENCH_SCHEDULE", "flooding")
    reps = int(os.environ.get("BENCH_REPS", "8"))

    fn = (minsum.decode_layered if schedule == "layered"
          else minsum.decode_flooding)
    decode = jax.jit(functools.partial(
        fn, code=code, num_iters=iters, check="zero", early_stop=False,
        msg_dtype=dtype))
    # two alternating channel buffers: distinct inputs per call, bounded
    # device memory
    bufs = [1.0 + 0.6 * jax.random.normal(jax.random.PRNGKey(i),
                                          (B, code.L, code.Z),
                                          dtype=jnp.float32)
            for i in range(min(reps, 2))]
    jax.block_until_ready(decode(bufs[0]))          # compile + warm up

    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    t0 = time.perf_counter()
    outs = [decode(bufs[i % len(bufs)]) for i in range(reps)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    if profile_dir:
        jax.profiler.stop_trace()

    mbps = reps * B * code.k / dt / 1e6
    print(json.dumps({
        "metric": "binary_minsum_info_throughput",
        "value": round(mbps, 2),
        "unit": "Mb/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "code": code.name, "batch": B, "iters": iters, "schedule": schedule,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
