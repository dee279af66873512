"""Packed multi-SNR streaming sweep: the jnp stream engines with per-slot
SNR-point ids, checkpoints and kill/resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu import config as cfg, sim
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode


def _bin_cfg(tmpdir_seed=0, batch_per_device=16):
    return cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=3, check="zero"),
        sweep=cfg.SweepConfig(snr_start=4.0, snr_step=2.0, snr_stop=6.0,
                              snr_type="ebn0", least_error_frames=1,
                              least_test_frames=16, max_frames=64,
                              display_step=10**9, seed=tmpdir_seed),
        batch_per_device=batch_per_device, engine="stream", stream_steps=2)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_binary_stream_packed_sweep(tmp_path, n_dev):
    """Full packed stream sweep (per-ITERATION refill) on a 1- and an
    8-device mesh at the same global batch, then a checkpointed re-run."""
    ckpt = str(tmp_path / "ck.json")
    mesh = sim.get_mesh(jax.devices()[:n_dev])
    scfg = _bin_cfg(batch_per_device=16 // n_dev)
    res = sim.run_binary_stream_packed(scfg, mesh=mesh, quiet=True,
                                       checkpoint=ckpt)
    assert len(res.rows) == 2
    for r in res.rows:
        # stop rule honored: at least least_test_frames collected (the
        # pipeline may overshoot; max_frames caps a no-error point)
        assert 16 <= r["frames"]
        assert 0 <= r["error_frames"] <= r["frames"]
        assert 0.0 <= r["fer"] <= 1.0
        assert r["iter_sum"] <= r["frames"] * 3
    # 6 dB should not be worse than 4 dB by more than MC noise allows here
    assert res.rows[1]["fer"] <= res.rows[0]["fer"] + 0.25
    # finished sweep re-run: short-circuits to the checkpointed rows
    res2 = sim.run_binary_stream_packed(scfg, mesh=mesh, quiet=True,
                                        checkpoint=ckpt)
    assert [r["frames"] for r in res2.rows] == \
        [r["frames"] for r in res.rows]


@pytest.mark.parametrize("method,steps", [("qspa", 2), ("layered_qspa", 4)])
def test_nb_stream_packed_factory(method, steps):
    """One run+drain cycle of the NB packed stream factory: per-iteration
    refill adopts the driver's refill point id; exactly-once accounting
    across two points."""
    code = NBCode.from_registry("BDS.576.288.GF.64")
    scfg = cfg.NBSimConfig(
        code="BDS.576.288.GF.64",
        decoder=cfg.NBDecoderConfig(method=method, max_iters=3),
        batch_per_device=16, engine="stream", stream_steps=steps)
    sigmas = np.array([0.8, 0.9], np.float32)
    mesh = sim.get_mesh(jax.devices()[:1])
    init_fn, run_fn, drain_fn, B = sim.make_nb_stream_packed_fn(
        code, scfg, sigmas, mesh)
    assert B == 16
    key = jax.random.PRNGKey(0)
    pid0 = jnp.asarray(np.arange(B, dtype=np.int32) % 2)
    state = init_fn(key, pid0)
    refill = jnp.asarray(np.zeros(B, np.int32))   # point 1 finished, say
    state, c1 = run_fn(state, jax.random.fold_in(key, 1), refill)
    state, c2 = drain_fn(state, jax.random.fold_in(key, 2))
    c1, c2 = np.asarray(c1), np.asarray(c2)
    assert c1.shape == (2, 6) and c2.shape == (2, 6)
    tot = c1 + c2
    # every started frame lands in exactly one point's tally: the initial
    # B split 8/8, plus any refills (attributed to point 0 by `refill`)
    assert tot[:, 0].sum() >= B
    assert tot[1, 0] == 8                 # point 1 got no refills
    assert (tot[:, 1] <= tot[:, 0]).all()
    # drain leaves no live slot
    assert not np.asarray(state[2]).any()


def test_packed_stream_kill_resume(tmp_path):
    """Interrupt mid-sweep after N consumed calls, resume from the
    checkpoint: no started frame is lost or double-counted (the resumed
    run completes every point's stop rule; frames never decrease)."""
    ckpt = str(tmp_path / "kr.json")
    scfg = cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=3, check="zero"),
        sweep=cfg.SweepConfig(snr_start=4.0, snr_step=2.0, snr_stop=6.0,
                              snr_type="ebn0", least_error_frames=1,
                              least_test_frames=64, max_frames=256,
                              display_step=10**9, stream_ckpt_s=10**9),
        batch_per_device=4, engine="stream", stream_steps=2)
    mesh = sim.get_mesh(jax.devices()[:2])
    sim._STREAM_TEST_INTERRUPT = 2
    try:
        with pytest.raises(KeyboardInterrupt):
            sim.run_binary_stream_packed(scfg, mesh=mesh, quiet=True,
                                         checkpoint=ckpt)
    finally:
        sim._STREAM_TEST_INTERRUPT = None
    import json
    saved = json.load(open(ckpt))["stream_packed"]
    frames_at_kill = sum(d["frames"] for d in saved["stats"])
    assert frames_at_kill > 0
    res = sim.run_binary_stream_packed(scfg, mesh=mesh, quiet=True,
                                       checkpoint=ckpt)
    assert len(res.rows) == 2
    total = sum(r["frames"] for r in res.rows)
    assert total >= frames_at_kill         # nothing lost
    for r in res.rows:
        assert r["frames"] >= 64 or r["error_frames"] >= 1
        assert 0 <= r["error_frames"] <= r["frames"]


def test_binary_packed_factory_rejects_unsupported():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    scfg = _bin_cfg()
    scfg = cfg.BinarySimConfig(
        code=scfg.code, decoder=cfg.BinaryDecoderConfig(check="none"),
        batch_per_device=16)
    with pytest.raises(ValueError, match="per-frame check"):
        sim.make_binary_stream_packed_fn(code, scfg, np.array([0.5]))