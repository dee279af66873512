"""NB continuous-batching engine (sim.make_nb_stream_fn) vs a loop-level
reference driving nb_decode.build_core with the engine's per-iteration
semantics (decide -> GF syndrome -> account -> frozen step).

Mirror of tests/test_minsum_stream.py for the non-binary decoders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu import config as cfg, sim
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.ops import nb_decode


def _ref_drain(core, carry, tx, max_iters):
    decide, step = jax.jit(core.decide), jax.jit(core.step)
    B = tx.shape[0]
    t = np.zeros(B, np.int64)
    alive = np.ones(B, bool)
    counters = np.zeros(6, np.int64)
    for _ in range(max_iters + 1):
        hard, llr = decide(carry)
        ok = np.asarray(nb_decode._syndrome_ok(core.g, hard))
        done = alive & (ok | (t >= max_iters))
        errsyms = np.sum(np.asarray(hard) != tx, axis=1)
        has_err = errsyms > 0
        counters += [done.sum(), (done & has_err).sum(),
                     (done * errsyms).sum(), (done & has_err & ok).sum(),
                     (done & ~has_err & ~ok).sum(), (done * t).sum()]
        cont = alive & ~done
        carry = step(carry, llr, jnp.asarray(cont))
        alive = cont
        t = np.where(cont, t + 1, t)
    assert not alive.any()
    return counters


CASES = [("BDS.576.288.GF.64", "qspa", 1.5),
         ("BDS.576.288.GF.64", "layered_qspa", 1.5),
         ("BDS.576.288.GF.64", "ems", 3.0),
         ("BDS.576.288.GF.64", "tmm", 3.0),
         ("LDPC_N96_K48_GF256_d1_exp", "qspa", 4.0),
         ("LDPC_N96_K48_GF256_d1_exp", "layered_qspa", 4.0)]


@pytest.mark.parametrize("name,method,snr", CASES)
def test_drain_matches_loop_reference(name, method, snr):
    code = NBCode.from_registry(name)
    max_it = 6
    scfg = cfg.NBSimConfig(
        code=name, batch_per_device=8, engine="stream", stream_steps=3,
        decoder=cfg.NBDecoderConfig(method=method, max_iters=max_it))
    from cuda_ldpc_tpu.ops import channel
    sigma = channel.sigma_from_snr(snr, code.rate, "ebn0", 1.0)
    init_fn, run_fn, drain_fn, B = sim.make_nb_stream_fn(
        code, scfg, sim.get_mesh(jax.devices()[:1]))
    key = jax.random.PRNGKey(5)
    state = init_fn(key, sigma)
    (carry, tx), _, _ = state
    core = nb_decode.build_core(code, method)
    ref = _ref_drain(core, carry, np.asarray(tx), max_it)
    _, got = drain_fn(state, jax.random.fold_in(key, 1), sigma)
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert ref[0] == B


def test_run_then_drain_accounts_every_frame():
    """run refills finished slots every iteration; run + drain counts every
    started frame exactly once, and the drained state has no live slot."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    scfg = cfg.NBSimConfig(
        code="BDS.576.288.GF.64",
        decoder=cfg.NBDecoderConfig(method="layered_qspa", max_iters=4),
        batch_per_device=16, engine="stream", stream_steps=3)
    key = jax.random.PRNGKey(0)
    sigma = 0.9
    init_fn, run_fn, drain_fn, B = sim.make_nb_stream_fn(
        code, scfg, sim.get_mesh(jax.devices()[:1]))
    assert B == 16
    state = init_fn(key, sigma)
    state, c1 = run_fn(state, jax.random.fold_in(key, 1), sigma)
    state, c2 = drain_fn(state, jax.random.fold_in(key, 2), sigma)
    c1, c2 = np.asarray(c1), np.asarray(c2)
    assert c2[0] == B                      # each slot drained exactly once
    assert 0 <= c1[1] <= c1[0] and 0 <= c2[1] <= c2[0]
    assert c1[5] <= c1[0] * 4 and c2[5] <= c2[0] * 4
    _, _, alive = state
    assert not np.asarray(alive).any()


def test_nb_decoder_rejects_unknown_method():
    code = NBCode.from_registry("BDS.576.288.GF.64")
    scfg = cfg.NBSimConfig(decoder=cfg.NBDecoderConfig(method="nope"),
                           batch_per_device=8)
    with pytest.raises(ValueError, match="unknown NB decoder method"):
        sim.make_nb_step(code, scfg, sim.get_mesh(jax.devices()[:1]))
