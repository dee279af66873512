"""Sweep driver: statistics, stop rule, output schema, checkpoint/resume,
mesh sharding, CLI."""

import json
import os

import numpy as np
import pytest

from cuda_ldpc_tpu import cli, config as cfg, sim
from cuda_ldpc_tpu.parallel import get_mesh


def tiny_binary_cfg(**kw):
    return cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=8, check="zero"),
        sweep=cfg.SweepConfig(snr_start=3.0, snr_step=0.5, snr_stop=3.5,
                              snr_type="ebn0", least_error_frames=2,
                              least_test_frames=64, max_frames=256,
                              display_step=10**6, seed=7),
        batch_per_device=8, **kw)


def test_binary_sweep_runs(tmp_path):
    res = sim.run_binary_sweep(tiny_binary_cfg(), out_dir=str(tmp_path),
                               quiet=True)
    assert len(res.rows) == 2
    for row in res.rows:
        assert row["frames"] >= 64
        assert 0.0 <= row["fer"] <= 1.0
        assert row["info_mbps"] > 0
    lines = (tmp_path / "results.txt").read_text().strip().splitlines()
    assert len(lines) >= 2
    # row schema: SNR frames errors FER BER avgIT FER_False FER_Alarm
    parts = lines[-1].split()
    assert len(parts) == 8
    jl = [json.loads(x) for x in
          (tmp_path / "results.jsonl").read_text().splitlines()]
    assert jl[-1]["kind"] == "binary"


def test_binary_sweep_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    res1 = sim.run_binary_sweep(tiny_binary_cfg(), checkpoint=ck, quiet=True)
    assert os.path.exists(ck)
    # resume: completed points come back from the checkpoint verbatim
    res2 = sim.run_binary_sweep(tiny_binary_cfg(), checkpoint=ck, quiet=True)
    assert [r["frames"] for r in res1.rows] == [r["frames"] for r in res2.rows]
    assert [r["fer"] for r in res1.rows] == [r["fer"] for r in res2.rows]
    # a different config must NOT reuse the checkpoint
    other = tiny_binary_cfg()
    other.decoder.max_iters = 3
    state = json.load(open(ck))
    res3 = sim.run_binary_sweep(other, checkpoint=ck, quiet=True)
    assert json.load(open(ck))["key"] != state["key"]


def test_binary_sweep_sharded_mesh():
    mesh = get_mesh()  # all 8 virtual CPU devices
    assert mesh.devices.size == 8
    simcfg = tiny_binary_cfg()
    res = sim.run_binary_sweep(simcfg, mesh=mesh, quiet=True)
    # global batch = batch_per_device * n_devices
    assert res.rows[0]["frames"] % (8 * simcfg.batch_per_device) == 0


def test_binary_packed_sweep_matches_sequential_statistically():
    simcfg = tiny_binary_cfg()
    simcfg.sweep.snr_start, simcfg.sweep.snr_stop = 3.6, 4.1
    simcfg.sweep.snr_type = "ebn0"
    packed = sim.run_binary_sweep_packed(simcfg, quiet=True)
    seq = sim.run_binary_sweep(simcfg, quiet=True)
    assert len(packed.rows) == len(seq.rows) == 2
    for a, b in zip(packed.rows, seq.rows):
        assert a["snr"] == b["snr"]
        assert a["frames"] >= 64
        # same stop rule ballpark; FERs within loose statistical agreement
        assert abs(a["fer"] - b["fer"]) < 0.35


def test_nb_sweep_runs(tmp_path):
    simcfg = cfg.NBSimConfig(
        code="LDPC_N96_K48_GF256_d1_exp",
        decoder=cfg.NBDecoderConfig(method="tmm", max_iters=5),
        sweep=cfg.SweepConfig(snr_start=4.0, snr_step=1.0, snr_stop=4.0,
                              least_error_frames=1, least_test_frames=16,
                              max_frames=64, display_step=10**6),
        batch_per_device=2)
    res = sim.run_nb_sweep(simcfg, out_dir=str(tmp_path), quiet=True)
    assert len(res.rows) == 1
    row = res.rows[0]
    assert row["kind"] == "nb"
    assert row["frames"] >= 16
    line = (tmp_path / "results.txt").read_text().strip().splitlines()[-1]
    assert line.endswith("sec")


def test_binary_reference_channel_sweep():
    """'reference' channel mode: deterministic LCG noise, seeds reset per SNR
    point — two runs must produce IDENTICAL counters."""
    simcfg = tiny_binary_cfg(channel="reference")
    simcfg.sweep.max_frames = 64
    simcfg.sweep.least_test_frames = 32
    r1 = sim.run_binary_sweep(simcfg, quiet=True)
    r2 = sim.run_binary_sweep(simcfg, quiet=True)
    assert [x["error_units"] for x in r1.rows] == \
        [x["error_units"] for x in r2.rows]
    assert [x["frames"] for x in r1.rows] == [x["frames"] for x in r2.rows]


def test_nb_packed_sweep_runs():
    simcfg = cfg.NBSimConfig(
        code="LDPC_N96_K48_GF256_d1_exp",
        decoder=cfg.NBDecoderConfig(method="layered_tmm", max_iters=5),
        sweep=cfg.SweepConfig(snr_start=3.0, snr_step=1.0, snr_stop=4.0,
                              least_error_frames=1, least_test_frames=16,
                              max_frames=64, display_step=10**6),
        batch_per_device=4)
    res = sim.run_nb_sweep_packed(simcfg, quiet=True)
    assert len(res.rows) == 2
    assert all(r["frames"] >= 16 for r in res.rows)


def test_nb_stream_engine_statistical_parity():
    """Streaming (continuous-batching) engine vs the batch engine: identical
    channel/decoder/iteration accounting, so the FER estimates must be
    binomial-compatible (exact Clopper-Pearson CI overlap)."""
    from cuda_ldpc_tpu.utils import stats as st
    base = dict(
        code="LDPC_N96_K48_GF256_d1_exp",
        decoder=cfg.NBDecoderConfig(method="qspa", max_iters=8),
        sweep=cfg.SweepConfig(snr_start=2.0, snr_step=1.0, snr_stop=2.0,
                              least_error_frames=25, least_test_frames=400,
                              max_frames=4000, display_step=10**6),
        batch_per_device=16)
    rb = sim.run_nb_sweep(cfg.NBSimConfig(**base), quiet=True).rows[0]
    rs = sim.run_nb_sweep(cfg.NBSimConfig(**base, engine="stream",
                                          stream_steps=8), quiet=True).rows[0]
    assert rs["frames"] >= 400 and rs["error_frames"] >= 25
    assert st.rates_compatible(rb["error_frames"], rb["frames"],
                               rs["error_frames"], rs["frames"])
    # mean iterations must agree too (same decoder, same accounting)
    assert abs(rb["avg_iters"] - rs["avg_iters"]) < 1.5


def test_nb_stream_noiseless_exact_accounting():
    """With sigma ~ 0 every frame converges at iteration 0, so the streaming
    engine's accounting is exactly predictable: each run call counts
    B * stream_steps frames with zero errors and zero iterations, and the
    drain pass counts exactly the B in-flight frames."""
    import jax
    from cuda_ldpc_tpu import NBCode
    simcfg = cfg.NBSimConfig(
        code="LDPC_N96_K48_GF256_d1_exp",
        decoder=cfg.NBDecoderConfig(method="ems", max_iters=6),
        batch_per_device=1, stream_steps=5, engine="stream")
    code = NBCode.from_registry(simcfg.code)
    mesh = get_mesh()
    B = mesh.devices.size  # 1 per device
    init_fn, run_fn, drain_fn, Bq = sim.make_nb_stream_fn(code, simcfg, mesh)
    assert Bq == B
    key = jax.random.PRNGKey(0)
    sigma = 1e-4
    state = init_fn(key, sigma)
    state, c1 = run_fn(state, jax.random.fold_in(key, 1), sigma)
    state, c2 = run_fn(state, jax.random.fold_in(key, 2), sigma)
    for c in (c1, c2):
        frames, errf, erru, false, alarm, iters = (int(x)
                                                   for x in np.asarray(c))
        assert frames == B * simcfg.stream_steps
        assert errf == erru == false == alarm == iters == 0
    _, cd = drain_fn(state, jax.random.fold_in(key, 3), sigma)
    frames, errf, erru, false, alarm, iters = (int(x) for x in np.asarray(cd))
    assert frames == B            # exactly the in-flight frames, once
    assert errf == iters == 0


def test_nb_fixture_codeword_loads():
    from cuda_ldpc_tpu.utils import registry
    cw = registry.load_test_codeword(96)
    assert cw.shape == (96,)
    assert cw.min() >= 0 and cw.max() < 64
    # it must be a valid codeword of the GF(64) code? (the reference never
    # checks; we only check range here)


def test_cli_parses_and_lists(capsys):
    assert cli.main(["list-codes"]) == 0
    out = capsys.readouterr().out
    assert "J15_L30_Z1280" in out and "BDS.576.288.GF.64" in out
    p = cli.build_parser()
    args = p.parse_args(["binary", "--code", "J4_L24_Z96", "--snr", "1:0.5:2",
                         "--schedule", "layered", "--alpha", "0.8"])
    assert args.alpha == 0.8
    with pytest.raises(SystemExit):
        p.parse_args(["binary", "--code", "not_a_code"])


def test_snr_points_float_accumulation():
    s = cfg.SweepConfig(snr_start=0.0, snr_step=0.2, snr_stop=1.0)
    assert s.snr_points() == [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]


def test_cli_nb_qspa_end_to_end(tmp_path, capsys):
    # smallest NB code, one SNR point, tiny budgets: exercises the full CLI ->
    # config -> sweep -> decoder wiring for the qspa method
    rc = cli.main(["nb", "--code", "LDPC_N96_K48_GF256_d1_exp",
                   "--method", "qspa", "--batch", "8", "--snr", "4:1:4",
                   "--least-error-frames", "1", "--least-test-frames", "8",
                   "--max-frames", "16", "--out-dir", str(tmp_path)])
    assert rc == 0
    rows = (tmp_path / "results.jsonl").read_text().strip().splitlines()
    assert rows and '"snr": 4' in rows[-1]


def test_binary_stream_engine_runs(tmp_path):
    """Continuous-batching binary engine: sweep completes, counters sane,
    FER in the same regime as the batch engine at the same point."""
    c = tiny_binary_cfg(engine="stream", stream_steps=4)
    c.decoder.check = "syndrome"
    res = sim.run_binary_sweep(c, out_dir=str(tmp_path), quiet=True)
    assert len(res.rows) == 2
    for row in res.rows:
        assert row["frames"] >= 64
        assert 0.0 <= row["fer"] <= 1.0
        assert row["iter_sum"] >= 0
    jl = [json.loads(x) for x in
          (tmp_path / "results.jsonl").read_text().splitlines()]
    assert jl[-1]["kind"] == "binary"


def test_binary_stream_random_tx():
    """Stream engine + tx='random': per-slot codewords splice on refill; at
    high SNR everything decodes clean."""
    import jax
    c = tiny_binary_cfg(engine="stream", stream_steps=3, tx="random")
    c.decoder.check = "syndrome"
    from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
    code = QCBinaryCode.from_registry(c.code)
    init_fn, run_fn, drain_fn, B = sim.make_binary_stream_fn(code, c)
    key = jax.random.PRNGKey(0)
    st = init_fn(key, 0.35)                     # ~9 dB: error-free
    st, c1 = run_fn(st, jax.random.fold_in(key, 1), 0.35)
    st, c2 = drain_fn(st, jax.random.fold_in(key, 2), 0.35)
    tot = np.asarray(c1) + np.asarray(c2)
    assert tot[0] >= B                          # frames counted
    assert tot[1] == 0 and tot[2] == 0          # no errors


@pytest.mark.slow
def test_binary_stream_fer_matches_batch():
    """Statistical FER parity: stream vs batch engine at one SNR point."""
    from cuda_ldpc_tpu.utils.stats import rates_compatible
    base = dict(code="J4_L24_Z96",
                sweep=cfg.SweepConfig(snr_start=3.2, snr_step=1.0,
                                      snr_stop=3.2, snr_type="ebn0",
                                      least_error_frames=60,
                                      least_test_frames=3000,
                                      max_frames=20000,
                                      display_step=10**6, seed=11),
                batch_per_device=32)
    dec = cfg.BinaryDecoderConfig(max_iters=20, check="syndrome")
    rb = sim.run_binary_sweep(cfg.BinarySimConfig(
        decoder=dec, engine="batch", **base), quiet=True).rows[0]
    rs = sim.run_binary_sweep(cfg.BinarySimConfig(
        decoder=dec, engine="stream", stream_steps=8, **base), quiet=True).rows[0]
    assert rates_compatible(rb["error_frames"], rb["frames"],
                            rs["error_frames"], rs["frames"])


def test_stream_midpoint_checkpoint_resume(tmp_path):
    """Kill the streaming engine mid-point; resume reproduces the
    uninterrupted run's final statistics exactly (same call/key sequence,
    restored slot state, in-flight counters preserved)."""
    def cfg_nb():
        return cfg.NBSimConfig(
            code="BDS.576.288.GF.64", batch_per_device=8, engine="stream",
            stream_steps=3,
            decoder=cfg.NBDecoderConfig(method="qspa", max_iters=8),
            sweep=cfg.SweepConfig(snr_start=2.0, snr_step=1.0, snr_stop=2.0,
                                  least_error_frames=3,
                                  least_test_frames=400, max_frames=2000,
                                  display_step=10**6, seed=5,
                                  stream_ckpt_s=10**9))
    ref = sim.run_nb_sweep(cfg_nb(), quiet=True).rows[0]
    ckpt = str(tmp_path / "ck.json")
    sim._STREAM_TEST_INTERRUPT = 2
    try:
        with pytest.raises(KeyboardInterrupt):
            sim.run_nb_sweep(cfg_nb(), checkpoint=ckpt, quiet=True)
    finally:
        sim._STREAM_TEST_INTERRUPT = None
    assert os.path.exists(ckpt + ".state.npz")
    res = sim.run_nb_sweep(cfg_nb(), checkpoint=ckpt, quiet=True).rows[0]
    for k in ("frames", "error_frames", "error_units", "iter_sum",
              "false_frames", "alarm_frames"):
        assert res[k] == ref[k], (k, res[k], ref[k])
    assert not os.path.exists(ckpt + ".state.npz")   # cleaned after finish


def test_binary_packed_random_tx(tmp_path):
    """Packed multi-SNR sweep with tx='random' (the restriction the batch
    engine lifted in round 4): encoded frames, syndrome check, sane stats."""
    c = tiny_binary_cfg(tx="random")
    c.decoder.check = "syndrome"
    res = sim.run_binary_sweep_packed(c, out_dir=str(tmp_path), quiet=True)
    assert len(res.rows) == 2
    for row in res.rows:
        assert row["frames"] >= 64
        assert 0.0 <= row["fer"] <= 1.0


def test_profile_dir_traces_one_batch(tmp_path):
    """--profile DIR: one traced steady-state batch per SNR point (and the
    sweep's statistics are unaffected by the tracing path)."""
    prof = tmp_path / "trace"
    res = sim.run_binary_sweep(tiny_binary_cfg(), quiet=True,
                               profile_dir=str(prof))
    assert len(res.rows) == 2 and res.rows[0]["frames"] >= 64
    produced = list(prof.rglob("*")) if prof.exists() else []
    # jax.profiler works on CPU; if a backend ever refuses, the driver
    # degrades gracefully (consumes the batch untraced) — rows above prove it
    assert prof.exists() and len(produced) > 0
