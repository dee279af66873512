"""Encoders: every encoded word must satisfy the parity checks."""

import numpy as np
import pytest

from cuda_ldpc_tpu.models.encoder import BinaryEncoder, NBEncoder
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode


def test_binary_encoder_valid_codewords():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    enc = BinaryEncoder.from_code(code, cache=False)
    assert enc.k_eff >= code.k          # rank deficiencies only add dimension
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, size=(5, enc.k_eff))
    cw = enc.encode(msg)
    H = code.dense_H
    syn = (cw @ H.T) & 1
    assert not syn.any()
    # message bits embedded systematically
    np.testing.assert_array_equal(cw[:, enc.free], msg)


def test_binary_encoder_jax_matches_numpy():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    enc = BinaryEncoder.from_code(code, cache=False)
    rng = np.random.default_rng(1)
    msg = rng.integers(0, 2, size=(3, enc.k_eff))
    np.testing.assert_array_equal(np.asarray(enc.encode_jax(msg)),
                                  enc.encode(msg))


def test_binary_encode_decode_roundtrip():
    import jax
    import jax.numpy as jnp
    from cuda_ldpc_tpu.ops import channel, minsum

    code = QCBinaryCode.from_registry("J4_L24_Z96")
    enc = BinaryEncoder.from_code(code, cache=False)
    rng = np.random.default_rng(2)
    msg = rng.integers(0, 2, size=(4, enc.k_eff))
    cw = enc.encode(msg).reshape(4, code.L, code.Z)
    x = 1.0 - 2.0 * cw.astype(np.float32)
    chan = x + 0.45 * np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), x.shape))
    res = minsum.decode_flooding(jnp.asarray(chan), code, 30,
                                 check="syndrome")
    assert bool(np.all(np.asarray(res.ok)))
    np.testing.assert_array_equal(np.asarray(res.hard).reshape(4, -1),
                                  cw.reshape(4, -1))


def test_nb_encoder_valid_codewords():
    code = NBCode.from_registry("BDS.576.288.GF.64")
    enc = NBEncoder.from_code(code)
    assert enc.k_eff >= code.k_sym
    rng = np.random.default_rng(3)
    msg = rng.integers(0, code.q, size=(4, enc.k_eff))
    cw = enc.encode(msg)
    for b in range(4):
        assert not code.syndrome(cw[b]).any()
    np.testing.assert_array_equal(cw[:, enc.free], msg)


def test_nb_fixture_is_valid_codeword():
    """The reference's pinned GF(64) fixture should satisfy the BDS code."""
    from cuda_ldpc_tpu.utils import registry
    code = NBCode.from_registry("BDS.576.288.GF.64")
    cw = registry.load_test_codeword(96)
    assert not code.syndrome(cw).any()


def test_nb_encoder_jax_matches_numpy():
    code = NBCode.from_registry("BDS.576.288.GF.64")
    enc = NBEncoder.from_code(code, cache=False)
    rng = np.random.default_rng(4)
    m = code.q_bit
    bits = rng.integers(0, 2, size=(3, enc.k_eff * m)).astype(np.float32)
    # numpy path takes symbols (LSB-first bit packing, LDPC_Encoder.cpp:6-17)
    msg_syms = (bits.reshape(3, -1, m).astype(int)
                * (1 << np.arange(m))).sum(axis=2)
    np.testing.assert_array_equal(np.asarray(enc.encode_jax(bits)),
                                  enc.encode(msg_syms))


def test_nb_random_tx_step_counts_errors_fairly():
    """make_nb_step with tx='random': device-encoded codewords decode back to
    themselves at high SNR (counters ~0), and the syndrome check agrees."""
    import jax
    from cuda_ldpc_tpu import config as cfg
    from cuda_ldpc_tpu import sim as simmod

    code = NBCode.from_registry("BDS.576.288.GF.64")
    s = cfg.NBSimConfig(code=code.name, tx="random", batch_per_device=16,
                        decoder=cfg.NBDecoderConfig(method="qspa",
                                                    max_iters=10))
    fn, B = simmod.make_nb_step(code, s)
    out = np.asarray(fn(jax.random.PRNGKey(0), 0.28))   # ~11 dB: error-free
    errsyms, errf, falsef, alarmf, iters = (int(x) for x in out)
    assert errf == 0 and errsyms == 0
    assert falsef == 0 and alarmf == 0


def test_nb_random_tx_stream_smoke():
    """Streaming engine with tx='random': per-slot codewords ride the state
    tree and refills splice fresh ones (counters stay consistent)."""
    import jax
    from cuda_ldpc_tpu import config as cfg
    from cuda_ldpc_tpu import sim as simmod

    code = NBCode.from_registry("BDS.576.288.GF.64")
    s = cfg.NBSimConfig(code=code.name, tx="random", batch_per_device=8,
                        engine="stream", stream_steps=4,
                        decoder=cfg.NBDecoderConfig(method="qspa",
                                                    max_iters=6))
    init_fn, run_fn, drain_fn, B = simmod.make_nb_stream_fn(code, s)
    key = jax.random.PRNGKey(1)
    st = init_fn(key, 0.30)
    st, c1 = run_fn(st, jax.random.fold_in(key, 1), 0.30)
    st, c2 = drain_fn(st, jax.random.fold_in(key, 2), 0.30)
    c = np.asarray(c1) + np.asarray(c2)
    assert c[0] >= B                 # every slot finished at least one frame
    assert c[1] == 0 and c[2] == 0   # error-free at ~10.5 dB


@pytest.mark.slow
def test_nb_random_tx_fer_matches_zero_tx():
    """Linearity: FER with random encoded codewords is statistically
    identical to the all-zero transmission (the binary side proved the same
    in round 2; this is the NB criterion for tx='random')."""
    from cuda_ldpc_tpu import config as cfg
    from cuda_ldpc_tpu import sim as simmod
    from cuda_ldpc_tpu.utils.stats import rates_compatible

    base = dict(code="BDS.576.288.GF.64", batch_per_device=16,
                decoder=cfg.NBDecoderConfig(method="layered_qspa",
                                            max_iters=12),
                sweep=cfg.SweepConfig(snr_start=1.4, snr_step=1.0,
                                      snr_stop=1.4, least_error_frames=60,
                                      least_test_frames=2000,
                                      max_frames=12000,
                                      display_step=10**6, seed=31))
    rz = simmod.run_nb_sweep(cfg.NBSimConfig(tx="zero", **base),
                             quiet=True).rows[0]
    rr = simmod.run_nb_sweep(cfg.NBSimConfig(tx="random", **base),
                             quiet=True).rows[0]
    assert rr["error_frames"] > 0
    assert rates_compatible(rz["error_frames"], rz["frames"],
                            rr["error_frames"], rr["frames"])
