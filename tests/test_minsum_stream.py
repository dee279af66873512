"""Binary continuous-batching engine (sim.make_binary_stream_fn) vs a
loop-level reference driving minsum.build_core with the engine's
per-iteration semantics (decide -> check -> account -> frozen step), and the
core itself vs the batch decoders."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu import config as cfg, sim
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.ops import minsum


@pytest.fixture(scope="module")
def code():
    return QCBinaryCode.from_registry("J4_L24_Z96")


def _stream_cfg(schedule, check, rule, max_iters, B=8, steps=4):
    return cfg.BinarySimConfig(
        code="J4_L24_Z96", batch_per_device=B, engine="stream",
        stream_steps=steps,
        decoder=cfg.BinaryDecoderConfig(max_iters=max_iters, check=check,
                                        schedule=schedule, rule=rule))


def _ref_drain(code, core, carry, cw, max_iters, check, msg_cols):
    """Python loop over the core: every alive slot runs until its check
    passes or it reaches max_iters; returns the engine's six counters."""
    decide, step = jax.jit(core.decide), jax.jit(core.step)
    B = cw.shape[0]
    t = np.zeros(B, np.int64)
    alive = np.ones(B, bool)
    counters = np.zeros(6, np.int64)
    for _ in range(max_iters + 1):
        hard, totals = decide(carry)
        ok = np.asarray(minsum._check(code, hard, check))
        done = alive & (ok | (t >= max_iters))
        errbits = np.sum(np.asarray(hard)[:, :msg_cols]
                         != cw[:, :msg_cols], axis=(1, 2))
        has_err = errbits > 0
        counters += [done.sum(), (done & has_err).sum(),
                     (done * errbits).sum(), (done & has_err & ok).sum(),
                     (done & ~has_err & ~ok).sum(), (done * t).sum()]
        cont = alive & ~done
        carry = step(carry, totals, jnp.asarray(cont))
        alive = cont
        t = np.where(cont, t + 1, t)
    assert not alive.any()
    return counters


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("check", ["zero", "syndrome"])
def test_drain_matches_loop_reference(code, schedule, check, rule):
    max_it = 10
    scfg = _stream_cfg(schedule, check, rule, max_it)
    mesh = sim.get_mesh(jax.devices()[:1])
    init_fn, run_fn, drain_fn, B = sim.make_binary_stream_fn(code, scfg,
                                                             mesh)
    key = jax.random.PRNGKey(3)
    sigma = 0.42
    state = init_fn(key, sigma)
    (carry, cw), _, _ = state
    core = minsum.build_core(code, rule=rule, schedule=schedule)
    ref = _ref_drain(code, core, carry, np.asarray(cw), max_it, check,
                     code.L - code.J)
    _, got = drain_fn(state, jax.random.fold_in(key, 1), sigma)
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert ref[0] == B                     # every slot finished exactly once


def test_run_then_drain_accounts_every_frame(code):
    """run refills finished slots every iteration; run + drain counts each
    started frame exactly once (B initial frames plus every refill)."""
    scfg = _stream_cfg("flooding", "zero", "minsum", 6, B=16, steps=5)
    mesh = sim.get_mesh(jax.devices()[:1])
    init_fn, run_fn, drain_fn, B = sim.make_binary_stream_fn(code, scfg,
                                                             mesh)
    key = jax.random.PRNGKey(0)
    state = init_fn(key, 0.4)
    state, c1 = run_fn(state, jax.random.fold_in(key, 1), 0.4)
    (_, _), t, alive = state
    in_flight = int(np.sum(np.asarray(alive)))
    state, c2 = drain_fn(state, jax.random.fold_in(key, 2), 0.4)
    c1, c2 = np.asarray(c1), np.asarray(c2)
    assert in_flight == B                  # run keeps every slot busy
    assert c2[0] == B                      # drain finishes each slot once
    assert c1[0] >= 1                      # fast frames finished and left
    assert (c1[1] <= c1[0]) and (c2[1] <= c2[0])
    assert c1[5] <= c1[0] * 6 and c2[5] <= c2[0] * 6


@pytest.mark.parametrize("rule", ["minsum", "bp"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_core_reproduces_batch_decoder(code, schedule, rule):
    """build_core driven with every frame active reproduces the batch
    decoder's decisions iteration for iteration."""
    sigma = 0.6
    rng = np.random.default_rng(11)
    chan = (1.0 + sigma * rng.standard_normal((4, code.L, code.Z))
            ).astype(np.float32)
    if rule == "bp":
        chan = chan * np.float32(2.0 / sigma ** 2)
    core = minsum.build_core(code, rule=rule, schedule=schedule)
    carry = core.init(jnp.asarray(chan))
    cont = jnp.ones(4, bool)
    decode = (minsum.decode_layered if schedule == "layered"
              else minsum.decode_flooding)
    dec = jax.jit(functools.partial(decode, code=code, check="none",
                                    early_stop=False, rule=rule),
                  static_argnames="num_iters")
    step = jax.jit(core.step)
    for it in range(1, 4):
        if schedule == "flooding":
            hard, totals = core.decide(carry)     # flooding decides first
            carry = step(carry, totals, cont)
        else:
            _, totals = core.decide(carry)
            carry = step(carry, totals, cont)
            hard, _ = core.decide(carry)          # layered decides after
        ref = dec(jnp.asarray(chan), num_iters=it)
        np.testing.assert_array_equal(np.asarray(hard).astype(np.int8),
                                      np.asarray(ref.hard))
