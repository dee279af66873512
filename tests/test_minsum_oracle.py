"""Binary jnp decoders vs the row-wise NumPy oracle (tests/oracles.py) over
the shipped lifting factors, both schedules, both CN rules, normalized and
offset min-sum, every early-termination check and batch-global stopping.

Min-sum inputs are drawn on a 1/8 grid so every sum the decoders form is
exact in f32: decisions, ok flags and iteration counts must then agree with
the float64 oracle bit for bit.  The tanh rule is compared on firm bits."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum
from tests.oracles import decode_history

DECODERS = {"flooding": minsum.decode_flooding,
            "layered": minsum.decode_layered}


@functools.lru_cache(maxsize=None)
def _code(name):
    return QCBinaryCode.from_registry(name)


def grid_llr(code, batch, sigma, seed):
    """Noisy all-zero-codeword channel samples rounded to multiples of 1/8."""
    rng = np.random.default_rng(seed)
    x = 1.0 + sigma * rng.standard_normal((batch, code.L, code.Z))
    return (np.round(np.clip(x, -8, 8) * 8) / 8).astype(np.float32)


def oracle_frames(code, llr, iters, **kw):
    H = code.dense_H
    return [decode_history(f.reshape(-1), H, iters, **kw) for f in llr]


def frame_ok(code, hard_flat, check):
    if check == "syndrome":
        return not np.any((code.dense_H @ hard_flat.astype(np.int64)) % 2)
    if check == "zero":
        return not np.any(hard_flat[:(code.L - code.J) * code.Z])
    return False


@pytest.mark.parametrize("name,schedule,alpha,beta", [
    ("J4_L24_Z96", "flooding", 1.0, 0.0),
    ("J4_L24_Z256", "flooding", 1.0, 0.0),
    ("J10_L60_Z160", "flooding", 1.0, 0.0),
    ("J32_L64_Z64", "flooding", 1.0, 0.0),
    ("J4_L24_Z256", "flooding", 0.75, 0.125),
    ("J4_L24_Z96", "layered", 1.0, 0.0),
    ("J4_L24_Z256", "layered", 1.0, 0.0),
    ("J10_L60_Z160", "layered", 1.0, 0.0),
    ("J32_L64_Z64", "layered", 1.0, 0.0),
    ("J4_L24_Z96", "layered", 0.75, 0.125),
])
def test_minsum_matches_oracle(name, schedule, alpha, beta):
    code = _code(name)
    iters = 4
    llr = grid_llr(code, 3, 0.7, seed=sum(name.encode()))
    res = DECODERS[schedule](jnp.asarray(llr), code, iters, alpha=alpha,
                             beta=beta, check="none", early_stop=False)
    hist = oracle_frames(code, llr, iters, schedule=schedule, alpha=alpha,
                         beta=beta)
    for b, h in enumerate(hist):
        np.testing.assert_array_equal(
            np.asarray(res.hard[b]).reshape(-1).astype(bool), h[-1])
    assert int(res.iters) == iters


@pytest.mark.parametrize("name,schedule", [
    ("J4_L24_Z96", "flooding"), ("J4_L24_Z256", "flooding"),
    ("J4_L24_Z96", "layered"),
])
def test_bp_matches_oracle_firm_bits(name, schedule):
    """rule='bp': f32 phi-domain vs float64 tanh-product, compared where the
    oracle's decision is not razor-thin (checked via its neighbour
    iteration: a bit that flips between the last two iterations is soft)."""
    code = _code(name)
    sigma = 0.62
    rng = np.random.default_rng(21)
    llr = ((1.0 + sigma * rng.standard_normal((2, code.L, code.Z)))
           * (2.0 / sigma ** 2)).astype(np.float32)
    iters = 3
    res = DECODERS[schedule](jnp.asarray(llr), code, iters, check="none",
                             early_stop=False, rule="bp")
    hist = oracle_frames(code, llr, iters, schedule=schedule, rule="bp")
    for b, h in enumerate(hist):
        firm = h[-1] == h[-2]
        got = np.asarray(res.hard[b]).reshape(-1).astype(bool)
        assert firm.mean() > 0.9
        np.testing.assert_array_equal(got[firm], h[-1][firm])


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("check,early", [
    ("zero", True), ("zero", False), ("syndrome", True),
    ("syndrome", False), ("none", True), ("none", False)])
def test_check_and_batch_global_stop(schedule, check, early):
    """hard/ok/iters under every check, with and without early stop: the
    batch stops at the first iteration whose check passes for EVERY frame
    (the reference's all-frames host loop), else after num_iters."""
    code = _code("J4_L24_Z96")
    iters = 12
    llr = grid_llr(code, 5, 0.42, seed=3)
    res = DECODERS[schedule](jnp.asarray(llr), code, iters, check=check,
                             early_stop=early)
    hist = oracle_frames(code, llr, iters, schedule=schedule)
    oks = np.array([[frame_ok(code, h[t], check) for t in range(iters)]
                    for h in hist])                       # [B, iters]
    stop = iters
    if early:
        all_ok = np.flatnonzero(oks.all(axis=0))
        if all_ok.size:
            stop = int(all_ok[0]) + 1
    assert int(res.iters) == stop
    np.testing.assert_array_equal(np.asarray(res.ok), oks[:, stop - 1])
    for b, h in enumerate(hist):
        np.testing.assert_array_equal(
            np.asarray(res.hard[b]).reshape(-1).astype(bool), h[stop - 1])
    if check == "syndrome" and early:
        assert stop < iters             # this point converges: stop engaged


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_zero_iterations(schedule):
    code = _code("J4_L24_Z96")
    llr = grid_llr(code, 4, 0.6, seed=1)
    res = DECODERS[schedule](jnp.asarray(llr), code, 0, check="zero")
    assert int(res.iters) == 0
    assert not np.asarray(res.ok).any()
    assert not np.asarray(res.hard).any()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_bf16_storage_close_to_f32(schedule):
    """bf16 message storage quantizes messages; decisions agree on nearly
    every bit at a comfortable SNR."""
    code = _code("J4_L24_Z256")
    llr = jnp.asarray(grid_llr(code, 8, 0.5, seed=9))
    a = DECODERS[schedule](llr, code, 6, check="zero")
    b = DECODERS[schedule](llr, code, 6, check="zero",
                           msg_dtype=jnp.bfloat16)
    assert np.mean(np.asarray(a.hard) == np.asarray(b.hard)) > 0.999
    assert abs(np.asarray(a.ok).mean() - np.asarray(b.ok).mean()) <= 0.25
