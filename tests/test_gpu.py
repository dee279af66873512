"""On-card test: the jnp decoders on the GPU match the CPU bit for bit.

conftest.py pins this process to the CPU, so the check runs in a child
process that JAX lets see the GPU.  Skips where there is no NVIDIA GPU; the
full on-card check is ``python chip_smoke.py``."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHILD = """
import functools, jax, numpy as np
from cuda_ldpc_tpu import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum
if jax.devices()[0].platform != "gpu":
    print("NO_GPU"); raise SystemExit(0)
code = QCBinaryCode.from_registry("J4_L24_Z96")
rng = np.random.default_rng(0)
chan = (1.0 + 0.5 * rng.standard_normal((32, code.L, code.Z))).astype(np.float32)
for decode in (minsum.decode_flooding, minsum.decode_layered):
    fn = jax.jit(functools.partial(decode, code=code, num_iters=8,
                                   check="syndrome"))
    g, c = (fn(jax.device_put(chan, d)) for d in
            (jax.devices()[0], jax.devices("cpu")[0]))
    for a, b in zip(g, c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
print("GPU_PARITY_OK")
"""


@pytest.mark.gpu
def test_minsum_gpu_matches_cpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout + out.stderr
    if "NO_GPU" in out.stdout:
        pytest.skip("JAX found no GPU")
    assert "GPU_PARITY_OK" in out.stdout
