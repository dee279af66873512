"""Binary min-sum decoder vs the dense-H NumPy oracle + end-to-end decode tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.ops import channel, minsum
from tests.oracles import bp_flooding_dense, minsum_flooding_dense


def tiny_code():
    # small hand-rolled QC code: J=2, L=4, Z=4 (rate 1/2), full rank not required
    base = np.array([[0, 1, 2, -1],
                     [3, -1, 0, 1]])
    return QCBinaryCode(name="tiny", base=base, Z=4)


def small_shipped_code():
    try:
        return QCBinaryCode.from_registry("J4_L24_Z96")
    except FileNotFoundError:
        pytest.skip("J4_L24_Z96 asset not available")


@pytest.mark.parametrize("iters", [1, 3, 7])
def test_flooding_matches_oracle_tiny(iters):
    code = tiny_code()
    rng = np.random.default_rng(42)
    B = 3
    llr = rng.normal(size=(B, code.L, code.Z)).astype(np.float32)
    res = minsum.decode_flooding(jnp.asarray(llr), code, iters, early_stop=False,
                                 check="none")
    H = code.dense_H
    for b in range(B):
        hard_o, _, _, _ = minsum_flooding_dense(
            llr[b].reshape(-1).astype(np.float64), H, iters)
        np.testing.assert_array_equal(
            np.asarray(res.hard[b]).reshape(-1), hard_o.astype(np.int8))


def test_flooding_matches_oracle_shipped():
    code = small_shipped_code()
    rng = np.random.default_rng(7)
    llr = rng.normal(loc=1.0, scale=0.8,
                     size=(2, code.L, code.Z)).astype(np.float32)
    res = minsum.decode_flooding(jnp.asarray(llr), code, 5, early_stop=False,
                                 check="none")
    H = code.dense_H
    for b in range(2):
        hard_o, _, _, _ = minsum_flooding_dense(
            llr[b].reshape(-1).astype(np.float64), H, 5)
        np.testing.assert_array_equal(
            np.asarray(res.hard[b]).reshape(-1), hard_o.astype(np.int8))


def test_syndrome_ok_matches_dense():
    code = tiny_code()
    rng = np.random.default_rng(3)
    hard = rng.integers(0, 2, size=(16, code.L, code.Z)).astype(bool)
    ok = minsum.syndrome_ok(code, jnp.asarray(hard))
    H = code.dense_H
    expect = [(H @ hard[b].reshape(-1).astype(np.int64) % 2 == 0).all()
              for b in range(16)]
    np.testing.assert_array_equal(np.asarray(ok), expect)


@pytest.mark.parametrize("decode", [minsum.decode_flooding, minsum.decode_layered])
def test_decodes_allzero_at_high_snr(decode):
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(6.0, code.rate, "ebn0")
    key = jax.random.PRNGKey(0)
    llr = channel.bpsk_awgn_llr(key, jnp.zeros((code.L, code.Z)), sigma, 8)
    res = decode(llr, code, 30)
    assert bool(jnp.all(res.ok))
    assert not bool(jnp.any(res.hard))
    assert int(res.iters) < 30   # early termination engaged


def test_early_stop_vs_zero_check_equivalence():
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(3.5, code.rate, "ebn0")
    llr = channel.bpsk_awgn_llr(jax.random.PRNGKey(1),
                                jnp.zeros((code.L, code.Z)), sigma, 16)
    r1 = minsum.decode_flooding(llr, code, 20, check="syndrome")
    r2 = minsum.decode_flooding(llr, code, 20, check="zero")
    # for the all-zero codeword a zero-decoded frame always passes the true
    # syndrome; frames flagged ok by 'zero' are exactly the error-free ones
    ok2 = np.asarray(r2.ok)
    errs2 = np.asarray(r2.hard[:, :code.L - code.J]).any(axis=(1, 2))
    np.testing.assert_array_equal(ok2, ~errs2)
    assert np.asarray(r1.ok).sum() >= ok2.sum() - 1  # syndrome can pass non-zero words


@pytest.mark.parametrize("iters", [1, 3, 7])
def test_bp_matches_oracle_tiny(iters):
    """rule='bp' (exact sum-product, the reference's declared-but-unimplemented
    decoder_method=1, define.cuh:33-34) vs an independent float64 tanh-product
    oracle.  Hard decisions compared where the oracle total is not razor-thin
    (f32 phi-domain vs f64 tanh-product differ only at ~1e-6 totals)."""
    code = tiny_code()
    rng = np.random.default_rng(5)
    B = 4
    llr = rng.normal(loc=0.5, scale=2.0,
                     size=(B, code.L, code.Z)).astype(np.float32)
    res = minsum.decode_flooding(jnp.asarray(llr), code, iters,
                                 early_stop=False, check="none", rule="bp")
    H = code.dense_H
    for b in range(B):
        hard_o, total_o, _, _ = bp_flooding_dense(
            llr[b].reshape(-1).astype(np.float64), H, iters)
        firm = np.abs(total_o) > 1e-3
        got = np.asarray(res.hard[b]).reshape(-1).astype(bool)
        np.testing.assert_array_equal(got[firm], hard_o[firm])


def test_bp_not_worse_than_minsum():
    """At a waterfall operating point exact BP must correct at least as many
    frames as (unnormalized) min-sum on the same noise realizations."""
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(2.6, code.rate, "ebn0")
    llr = channel.bpsk_awgn_llr(jax.random.PRNGKey(9),
                                jnp.zeros((code.L, code.Z)), sigma, 64)
    # bp needs true LLRs; min-sum is scale-invariant so the scale is harmless
    llr_true = llr * (2.0 / sigma**2)
    r_ms = minsum.decode_flooding(llr_true, code, 20, check="zero")
    r_bp = minsum.decode_flooding(llr_true, code, 20, check="zero", rule="bp")
    assert int(r_bp.ok.sum()) >= int(r_ms.ok.sum())


@pytest.mark.parametrize("rule", ["minsum", "bp"])
def test_layered_rules_decode_allzero(rule):
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(5.0, code.rate, "ebn0")
    llr = channel.bpsk_awgn_llr(jax.random.PRNGKey(4),
                                jnp.zeros((code.L, code.Z)), sigma, 8)
    res = minsum.decode_layered(llr * (2.0 / sigma**2), code, 30, rule=rule)
    assert bool(jnp.all(res.ok))
    assert not bool(jnp.any(res.hard))


def test_int8_quantized_messages_decode():
    """Fake-int8 message quantization (the VALIDATION.md FER study knob): at a
    comfortable SNR the quantized decoder still corrects everything."""
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(5.5, code.rate, "ebn0")
    llr = channel.bpsk_awgn_llr(jax.random.PRNGKey(21),
                                jnp.zeros((code.L, code.Z)), sigma, 16)
    res = minsum.decode_flooding(llr, code, 30, int8_scale=16.0)
    assert bool(jnp.all(res.ok))
    assert not bool(jnp.any(res.hard))
    # grid actually applies: all message values land on multiples of 1/16
    q = minsum._fake_int8(llr, 16.0)
    np.testing.assert_array_equal(np.asarray(q * 16), np.round(np.asarray(q * 16)))


def test_layered_converges_faster_or_equal():
    code = small_shipped_code()
    sigma = channel.sigma_from_snr(4.0, code.rate, "ebn0")
    llr = channel.bpsk_awgn_llr(jax.random.PRNGKey(2),
                                jnp.zeros((code.L, code.Z)), sigma, 8)
    rf = minsum.decode_flooding(llr, code, 40)
    rl = minsum.decode_layered(llr, code, 40)
    assert bool(jnp.all(rl.ok))
    assert int(rl.iters) <= int(rf.iters)
