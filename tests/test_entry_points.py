"""Entry points: compile-cache placement, the GPU-only scripts' refusal to
run without a GPU, and chip_smoke.py's comparison helpers at small size."""

import os
import pathlib
import shutil
import subprocess
import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum
from cuda_ldpc_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **extra)
    return env


# -- compile cache ---------------------------------------------------------

def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.cache_dir()


_COMPILE_ONE = """
import sys, pathlib, jax, jax.numpy as jnp
from cuda_ldpc_tpu.utils import compile_cache as c
if len(sys.argv) > 1:
    c.REPO_CACHE_DIR = pathlib.Path(sys.argv[1])
print(c.enable_compile_cache())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.ones(7)).block_until_ready()
"""


def test_cache_lands_in_env_dir(tmp_path):
    out = subprocess.run([sys.executable, "-c", _COMPILE_ONE],
                         env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_cache_lands_in_repo_dir_without_env(tmp_path):
    repo_dir = tmp_path / "checkout_cache"
    out = subprocess.run([sys.executable, "-c", _COMPILE_ONE, str(repo_dir)],
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(repo_dir)
    assert any(repo_dir.iterdir())


# -- no GPU, no result -----------------------------------------------------

@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_without_gpu(script):
    out = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- chip_smoke helpers ----------------------------------------------------

class _Res(NamedTuple):
    hard: np.ndarray
    ok: np.ndarray
    iters: np.ndarray


def _binary_pair():
    """The same decode twice on the CPU (identical), plus a run with one
    iteration less (different)."""
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    rng = np.random.default_rng(0)
    chan = jnp.asarray((1.0 + 0.55 * rng.standard_normal(
        (8, code.L, code.Z))).astype(np.float32))
    a = minsum.decode_flooding(chan, code, 5, check="syndrome")
    b = minsum.decode_flooding(chan, code, 5, check="syndrome")
    c = minsum.decode_flooding(chan, code, 1, check="syndrome")
    return a, b, c


def test_compare_exact_small_decode():
    a, b, c = _binary_pair()
    assert chip_smoke.compare_exact(a, b) == {"hard": True, "ok": True,
                                              "iters": True}
    res = chip_smoke.compare_exact(a, c)
    assert not res["iters"] and not res["hard"]


def test_frame_agreement_counts_frames():
    hard = np.zeros((4, 3, 5), np.int8)
    other = hard.copy()
    other[1, 2, 4] = 1
    a = _Res(hard, np.ones(4, bool), np.int32(3))
    b = _Res(other, np.ones(4, bool), np.int32(3))
    assert chip_smoke.frame_agreement(a, b) == 0.75
    assert chip_smoke.frame_agreement(a, a) == 1.0


def test_compare_tolerant_rules():
    hard = np.zeros((20, 6), np.int32)
    ok = np.ones(20, bool)
    it = np.full(20, 3, np.int32)
    a = _Res(hard, ok, it)
    # a non-converged frame may drift; the pass holds
    h2, ok2 = hard.copy(), ok.copy()
    h2[0, 1], ok2[0] = 5, False
    assert chip_smoke.compare_tolerant(a, _Res(h2, ok2, it))["pass"]
    # a frame converged on both but with different decisions fails
    h3 = hard.copy()
    h3[1, 0] = 2
    r = chip_smoke.compare_tolerant(a, _Res(h3, ok, it))
    assert not r["converged_identical"] and not r["pass"]
    # iteration drift beyond one on more than 10 % of frames fails
    it4 = it.copy()
    it4[:3] += 2
    assert not chip_smoke.compare_tolerant(a, _Res(hard, ok, it4))["pass"]


def test_fer_check_against_anchor():
    ae, af, _ = chip_smoke.ANCHORS["ems_3.0"]
    assert chip_smoke.fer_check(ae, af, "ems_3.0")["pass"]
    far = chip_smoke.fer_check(900, 2048, "ems_3.0")
    assert not far["pass"] and far["ci"][0] > far["anchor_ci"][1]


def test_anchors_are_consistent():
    for name, (errors, frames, source) in chip_smoke.ANCHORS.items():
        assert 0 <= errors <= frames, name
        assert source.startswith("VALIDATION.md"), name
