"""Monte-Carlo SNR-sweep simulation driver with reference statistics.

Re-expresses the reference's L7 layer (bldpc_实习/main.cu:9-174 +
Simulation.cu:12-285; myNBLDPC/src/main.cu:14-268 + Simulation.cpp:16-311) as a
host loop around jitted, batch-sharded channel+decode steps:

* per-SNR counters: frames, error frames, error bits/symbols, iteration sum,
  undetected-error (FER_False) and false-alarm (FER_Alarm) frames — the binary
  reference's self-consistency cross-check (Simulation.cu:245-285).
* stop rule: errors >= leastErrorFrames AND frames >= leastTestFrames
  (define.cuh:52-53, define.h:52-53), evaluated per batch.
* output: the reference's console row schema (binary: SNR frames errors FER
  BER avgIT FER_False FER_Alarm; NB: SNR frames errors FER BER avgIT sec/frame,
  Simulation.cpp:281-289), appended to results.txt, plus structured JSONL.
  (sec/frame here covers the whole jitted channel+decode+stats step; the
  reference's chrono wraps the decode call only, Simulation.cpp:52-77.)
* checkpoint/resume: counters persisted after every batch (the reference
  restarts a killed sweep from scratch; partial results only survived as
  results.txt rows — SURVEY.md section 5).

Seeds: one integer seed replaces the reference's (173,173,173) LCG triple;
keys fold in (process, snr index, batch counter) so every SNR point and every
host draws an independent, reproducible stream (main.cu:117-119 reset
semantics: the sweep is deterministic given the seed).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cuda_ldpc_tpu import config as cfg
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.ops import channel, demod, minsum, nb_decode
from cuda_ldpc_tpu.parallel import batch_sharding, get_mesh
from cuda_ldpc_tpu.utils import registry
from cuda_ldpc_tpu.utils.constellations import constellation


@dataclasses.dataclass
class SnrStats:
    """Counters for one SNR point (struct Simulation, bldpc_实习/struct.cuh:6-33)."""
    snr: float
    frames: int = 0
    error_frames: int = 0
    error_units: int = 0          # bits (binary) or symbols (NB)
    iter_sum: int = 0
    false_frames: int = 0        # bit errors but check passed  (FER_False)
    alarm_frames: int = 0        # no bit errors but check failed (FER_Alarm)
    decode_s: float = 0.0
    info_bits: int = 0
    units_per_frame: int = 1   # bits (binary) or symbols (NB) counted per frame
    # Frames covered by decode_s/info_bits.  The FIRST collected batch of each
    # point (per process run) is excluded from timing — it absorbs jit
    # (re)compilation and warmup — so throughput numbers are steady-state and
    # comparable across runs/resumes (frames/FER counters still include it).
    timed_frames: int = 0

    @classmethod
    def from_checkpoint(cls, d: dict) -> "SnrStats":
        st = cls(**d)
        # Checkpoints written before timed_frames existed cover ALL collected
        # frames with decode_s; default timed_frames=0 would otherwise make
        # decode_s/timed_frames overstate sec/frame after a resume.
        if st.decode_s > 0 and st.timed_frames == 0:
            st.timed_frames = st.frames
        return st

    @property
    def fer(self) -> float:
        return self.error_frames / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return (self.error_units / max(self.frames, 1)
                / max(self.units_per_frame, 1))

    def row(self, kind: str) -> str:
        avg_it = self.iter_sum / max(self.frames, 1)
        if kind == "binary":
            return (f" {self.snr:.1f} {self.frames:8d}  {self.error_frames:4d}"
                    f"  {self.fer:6.4e}  {self.ber:6.4e}  {avg_it:.2f}"
                    f"  {self.false_frames / max(self.frames, 1):6.4e}"
                    f"  {self.alarm_frames / max(self.frames, 1):6.4e}")
        sec = self.decode_s / max(self.timed_frames or self.frames, 1)
        return (f" {self.snr:.1f} {self.frames:8d}  {self.error_frames:4d}"
                f"  {self.fer:6.4e}  {self.ber:6.4e}  {avg_it:.2f}"
                f"  {sec:6.4e}sec")

    def to_dict(self, kind: str) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = kind
        d["fer"] = self.fer
        d["ber"] = self.ber
        d["avg_iters"] = self.iter_sum / max(self.frames, 1)
        d["info_mbps"] = (self.info_bits / self.decode_s / 1e6
                          if self.decode_s else 0.0)
        return d


@dataclasses.dataclass
class SweepResult:
    rows: list[dict]

    def fer_curve(self) -> dict[float, float]:
        return {r["snr"]: r["fer"] for r in self.rows}


class _Checkpoint:
    """Atomic JSON checkpoint of sweep progress keyed by a config hash."""

    def __init__(self, path: str | None, key: str):
        self.path = path
        self.key = key
        self.state = {"key": key, "done": {}, "current": None}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    old = json.load(f)
                if old.get("key") == key:
                    self.state = old
            except (json.JSONDecodeError, OSError):
                pass

    def done_rows(self) -> dict:
        return self.state["done"]

    def current(self, snr: float):
        cur = self.state.get("current")
        if cur and abs(cur["stats"]["snr"] - snr) < 1e-9:
            return cur
        return None

    def save(self, stats: SnrStats | None, batch_idx: int, units: int,
             extra: dict | None = None):
        if not self.path:
            return
        if stats is not None:
            d = dataclasses.asdict(stats)
            cur = {"stats": d, "batch_idx": batch_idx, "units": units}
            if extra:
                cur.update(extra)
            self.state["current"] = cur
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.path)

    def finish_point(self, stats: SnrStats, kind: str):
        self.state["done"][f"{stats.snr:g}"] = stats.to_dict(kind)
        self.state["current"] = None
        self.save(None, 0, 0)


def _write_logo(kind: str, lines: list[str], out_dir: str | None, quiet: bool):
    """Config banner + column header, like the reference's WriteLogo
    (bldpc_实习/Simulation.cu:176-240)."""
    header = {
        "binary": ("  SNR   frames  errF    FER         BER        avgIT"
                   "   FER_False   FER_Alarm"),
        "nb": ("  SNR   frames  errF    FER         BER        avgIT"
               "   sec/frame"),
    }[kind]
    text = "\n".join(["*" * 70, *lines, "*" * 70, header])
    if not quiet:
        print(text, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.txt"), "a") as f:
            f.write(text + "\n")


def _emit(row: str, jsonl: dict, out_dir: str | None, quiet: bool):
    if not quiet:
        print(row, flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "results.txt"), "a") as f:
            f.write(row + "\n")
        with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
            f.write(json.dumps(jsonl) + "\n")


def _config_key(*parts) -> str:
    blob = json.dumps([dataclasses.asdict(p) if dataclasses.is_dataclass(p)
                       else p for p in parts], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _run_sweep(kind: str, sweep: cfg.SweepConfig, units_per_frame: int,
               info_bits_per_frame: int, batch: int,
               step: Callable, out_dir: str | None, checkpoint: str | None,
               key_salt: str, quiet: bool,
               pipeline: bool = True,
               profile_dir: str | None = None) -> SweepResult:
    """Shared sweep loop.  ``step(snr_idx, batch_idx, sigma)`` LAUNCHES one
    batch (async jax dispatch) and returns a zero-arg ``collect`` that blocks
    and returns ``(n_frames, err_frames, err_units, iter_sum, false_f,
    alarm_f)``.  With ``pipeline=True`` the loop keeps ONE launched batch in
    flight so the device computes batch k+1 while batch k's counters travel
    back to the host (the fetch and the host's bookkeeping overlap device
    work instead of leaving it idle).  The stop rule is then evaluated on
    collected stats, so each point may run one batch past the rule; those
    frames are still counted (harmless for MC estimates — the reference
    itself only checks between batches, Simulation.cu:111-146).  ``pipeline=False`` collects every batch
    synchronously, reproducing the reference's exact stop behavior (used by
    the reference-channel parity mode)."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ck = _Checkpoint(checkpoint, key_salt)
    rows: list[dict] = []
    for si, snr in enumerate(sweep.snr_points()):
        done = ck.done_rows().get(f"{snr:g}")
        if done is not None:
            rows.append(done)
            continue
        stats = SnrStats(snr=snr, units_per_frame=units_per_frame)
        batch_idx = 0
        cur = ck.current(snr)
        if cur:
            stats = SnrStats.from_checkpoint(cur["stats"])
            batch_idx = cur["batch_idx"]
        collected = batch_idx
        first_collect = collected   # absorbs (re)compile+warmup; untimed
        next_display = (stats.frames // sweep.display_step + 1) * sweep.display_step
        t_last = time.perf_counter()

        def consume(collect):
            nonlocal collected, next_display, t_last
            nf, ef, eu, its, ff, af = collect()
            now = time.perf_counter()
            stats.frames += nf
            stats.error_frames += ef
            stats.error_units += eu
            stats.iter_sum += its
            stats.false_frames += ff
            stats.alarm_frames += af
            if collected != first_collect:     # steady-state batches only
                stats.decode_s += now - t_last   # marginal wall time
                stats.info_bits += nf * info_bits_per_frame
                stats.timed_frames += nf
            t_last = now
            collected += 1
            ck.save(stats, collected, units_per_frame)
            if stats.frames >= next_display:
                _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
                next_display += sweep.display_step

        pending = None
        while True:
            stopped = ((stats.error_frames >= sweep.least_error_frames
                        and stats.frames >= sweep.least_test_frames)
                       or stats.frames >= sweep.max_frames)
            nxt = None
            if not stopped and profile_dir is not None and batch_idx == 1:
                # trace ONE steady-state batch per point (batch 0 absorbed
                # the compile), launch+fetch synchronously inside the trace
                # (SURVEY section 5 tracing row).  The traced batch's wall
                # time includes profiler overhead; diagnostic mode only.
                tdir = os.path.join(profile_dir, f"{kind}_snr{snr:g}")
                try:
                    with jax.profiler.trace(tdir):
                        consume(step(si, batch_idx, snr))
                except Exception as e:  # profiler unavailable: run untraced
                    if not quiet:
                        print(f"[profile] trace failed: {e}", flush=True)
                    consume(step(si, batch_idx, snr))
                batch_idx += 1
                continue
            if not stopped:
                nxt = step(si, batch_idx, snr)
                batch_idx += 1
            if not pipeline and nxt is not None:
                consume(nxt)
                continue
            if pending is not None:
                consume(pending)
            pending = nxt
            if nxt is None:
                break
        _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
        ck.finish_point(stats, kind)
        rows.append(stats.to_dict(kind))
    return SweepResult(rows=rows)


# --------------------------------------------------------------------------
# binary simulator
# --------------------------------------------------------------------------

def _pick_binary_decode(dec_cfg: cfg.BinaryDecoderConfig):
    """The jnp batch decoder for the configured schedule and CN rule."""
    base = (minsum.decode_layered if dec_cfg.schedule == "layered"
            else minsum.decode_flooding)
    return functools.partial(base, rule=dec_cfg.rule)


def make_binary_step(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                     mesh=None):
    """Jitted batch step: (all-zero or random-encoded) codeword -> AWGN ->
    min-sum decode -> stats.  Returns (fn, batch)."""
    dec_cfg = sim.decoder
    mesh = mesh or get_mesh()
    n_dev = mesh.devices.size
    B = sim.batch_per_device * n_dev
    decode = _pick_binary_decode(dec_cfg)
    msg_cols = code.L - code.J if dec_cfg.message_only else code.L
    dtype = jnp.dtype(dec_cfg.msg_dtype)
    enc = None
    if sim.tx == "random":
        from cuda_ldpc_tpu.models.encoder import BinaryEncoder
        enc = BinaryEncoder.from_code(code)
        if dec_cfg.check == "zero":
            raise ValueError("tx='random' needs check='syndrome' (the "
                             "reference's zero-check only works for the "
                             "all-zero codeword)")
    shard = batch_sharding(mesh, 3)
    # min-sum is scale-invariant so raw channel samples work (the reference
    # feeds y directly, LDPC_Decoder.cu:203); exact sum-product needs true
    # LLRs 2y/sigma^2
    llr_scale = ((lambda chan, sigma: chan * (2.0 / (sigma * sigma)))
                 if dec_cfg.rule == "bp" else (lambda chan, sigma: chan))

    def step(key, sigma):
        if enc is None:
            cw = jnp.zeros((B, code.L, code.Z), dtype=jnp.float32)
        else:
            kmsg, key = jax.random.split(key)
            msg = jax.random.bernoulli(
                kmsg, 0.5, (B, enc.k_eff)).astype(jnp.float32)
            cw = enc.encode_jax(msg).reshape(B, code.L, code.Z)
            cw = cw.astype(jnp.float32)
        x = 1.0 - 2.0 * cw
        if sim.add_noise:
            noise = jax.random.normal(key, (B, code.L, code.Z),
                                      dtype=jnp.float32)
            chan = x + sigma * noise
        else:
            chan = x
        chan = jax.lax.with_sharding_constraint(llr_scale(chan, sigma), shard)
        res = decode(chan, code, dec_cfg.max_iters, alpha=dec_cfg.alpha,
                     beta=dec_cfg.beta, check=dec_cfg.check,
                     msg_dtype=dtype)
        errs = res.hard.astype(jnp.int32) != cw.astype(jnp.int32)
        errbits = jnp.sum(errs[:, :msg_cols].astype(jnp.int32), axis=(1, 2))
        has_err = errbits > 0
        frame_err = has_err | ~res.ok
        false_f = has_err & res.ok         # undetected error (FER_False)
        alarm_f = ~has_err & ~res.ok       # false alarm (FER_Alarm)
        # one packed counter vector -> ONE host fetch per batch (each separate
        # scalar fetch costs a full round trip through the device runtime)
        return jnp.stack([jnp.sum(errbits),
                          jnp.sum(frame_err.astype(jnp.int32)),
                          jnp.sum(false_f.astype(jnp.int32)),
                          jnp.sum(alarm_f.astype(jnp.int32)),
                          res.iters.astype(jnp.int32)])

    return jax.jit(step), B


def make_binary_ref_channel_step(code: QCBinaryCode,
                                 sim: cfg.BinarySimConfig, mesh=None):
    """Decode-only jitted step for host-generated channel tensors — used by
    the 'reference' channel mode, which reproduces the CUDA reference's exact
    LCG/Box-Muller noise sequence (bldpc_实习/LDPC_Encoder.cu:25-56) via the
    native library (falling back to the pure-Python LCG)."""
    dec_cfg = sim.decoder
    if dec_cfg.rule != "minsum":
        raise ValueError("channel='reference' exists for bit-parity with the "
                         "reference's min-sum; rule='bp' is unsupported there")
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    shard = batch_sharding(mesh, 3)
    decode = _pick_binary_decode(dec_cfg)
    msg_cols = code.L - code.J if dec_cfg.message_only else code.L
    dtype = jnp.dtype(dec_cfg.msg_dtype)

    def step(chan):
        chan = jax.lax.with_sharding_constraint(chan, shard)
        res = decode(chan, code, dec_cfg.max_iters, alpha=dec_cfg.alpha,
                     beta=dec_cfg.beta, check=dec_cfg.check, msg_dtype=dtype)
        errbits = jnp.sum(res.hard[:, :msg_cols].astype(jnp.int32),
                          axis=(1, 2))
        has_err = errbits > 0
        return jnp.stack([jnp.sum(errbits),
                          jnp.sum((has_err | ~res.ok).astype(jnp.int32)),
                          jnp.sum((has_err & res.ok).astype(jnp.int32)),
                          jnp.sum((~has_err & ~res.ok).astype(jnp.int32)),
                          res.iters.astype(jnp.int32)])

    return jax.jit(step), B


def _ref_channel_source(code: QCBinaryCode, B: int):
    """Per-SNR-point generator of reference-sequence channel batches."""
    from cuda_ldpc_tpu.utils import lcg as pylcg
    try:
        from cuda_ldpc_tpu.utils import native
        use_native = native.available()
    except Exception:
        use_native = False
    cw = np.zeros(code.n, dtype=np.uint8)

    class Source:
        def __init__(self):
            self.seeds = pylcg.DEFAULT_SEEDS

        def reset(self):
            self.seeds = pylcg.DEFAULT_SEEDS

        def next(self, sigma: float) -> np.ndarray:
            if use_native:
                from cuda_ldpc_tpu.utils import native
                out, self.seeds = native.awgn_binary(cw, sigma, B, self.seeds)
            else:
                gen = pylcg.ReferenceLCG(self.seeds)
                out = pylcg.awgn_binary(gen, cw, sigma, B)
                self.seeds = tuple(gen.seed)
            # [CW_Len, B] frame-interleaved -> [B, L, Z]
            return out.T.reshape(B, code.L, code.Z).astype(np.float32)

    return Source()


def make_binary_stream_fn(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                          mesh=None):
    """Continuous-batching binary decode engine (the NB stream engine's
    design — sim.make_nb_stream_fn — applied to the binary decoders, which
    the reference runs strictly batch-granular: its host loop iterates until
    EVERY frame of the 4096-frame batch converges,
    bldpc_实习/LDPC_Decoder.cu:94-156).  Every decoder iteration ends with a
    per-slot check; finished slots are counted and immediately re-seeded
    with a fresh frame, so throughput tracks the MEAN iteration count.

    Returns (init_fn, run_fn, drain_fn, B); counters = [frames, err_frames,
    err_bits, false, alarm, iter_sum].  Drives the jnp BinaryCore."""
    dec = sim.decoder
    if sim.tx == "random" and dec.check == "zero":
        raise ValueError("tx='random' needs check='syndrome'")
    if dec.check == "none":
        raise ValueError("engine='stream' needs a per-frame check "
                         "('zero' or 'syndrome')")
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    shard = batch_sharding(mesh, 3)
    core = minsum.build_core(code, rule=dec.rule, schedule=dec.schedule,
                             alpha=dec.alpha, beta=dec.beta,
                             msg_dtype=jnp.dtype(dec.msg_dtype))
    msg_cols = code.L - code.J if dec.message_only else code.L
    enc = None
    if sim.tx == "random":
        from cuda_ldpc_tpu.models.encoder import BinaryEncoder
        enc = BinaryEncoder.from_code(code)
    llr_scale = ((lambda chan, sigma: chan * (2.0 / (sigma * sigma)))
                 if dec.rule == "bp" else (lambda chan, sigma: chan))
    max_it = dec.max_iters
    n_steps = sim.stream_steps

    def fresh(key, sigma):
        if enc is None:
            cw = jnp.zeros((B, code.L, code.Z), jnp.float32)
        else:
            kmsg, key = jax.random.split(key)
            msg = jax.random.bernoulli(
                kmsg, 0.5, (B, enc.k_eff)).astype(jnp.float32)
            cw = enc.encode_jax(msg).reshape(B, code.L, code.Z)
            cw = cw.astype(jnp.float32)
        x = 1.0 - 2.0 * cw
        if sim.add_noise:
            chan = x + sigma * jax.random.normal(key, x.shape,
                                                 dtype=jnp.float32)
        else:
            chan = x
        chan = jax.lax.with_sharding_constraint(llr_scale(chan, sigma),
                                                shard)
        return (core.init(chan), cw.astype(jnp.int8))

    def init_fn(key, sigma):
        carry = fresh(key, sigma)
        return (carry, jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool))

    def _inner(refill: bool):
        def inner(i, val):
            ((carry, cw), t, alive), counters, key, sigma = val
            hard, totals = core.decide(carry)
            ok = minsum._check(code, hard, dec.check)
            done = alive & (ok | (t >= max_it))
            errs = hard[:, :msg_cols].astype(jnp.int32) \
                != cw[:, :msg_cols].astype(jnp.int32)
            errbits = jnp.sum(errs, axis=(1, 2))
            has_err = errbits > 0
            di = done.astype(jnp.int32)
            counters = counters + jnp.stack([
                jnp.sum(di),
                jnp.sum(di * has_err.astype(jnp.int32)),
                jnp.sum(di * errbits),
                jnp.sum(di * (has_err & ok).astype(jnp.int32)),
                jnp.sum(di * (~has_err & ~ok).astype(jnp.int32)),
                jnp.sum(di * t)])
            cont = alive & ~done
            carry = core.step(carry, totals, cont)
            if refill:
                new = fresh(jax.random.fold_in(key, i), sigma)
                carry, cw = jax.tree_util.tree_map(
                    lambda n, o: nb_decode._freeze(done, n, o), new,
                    (carry, cw))
                t = jnp.where(done, 0, t + 1)
            else:
                alive = cont
                t = jnp.where(cont, t + 1, t)
            return ((carry, cw), t, alive), counters, key, sigma
        return inner

    def run_fn(state, key, sigma):
        val = (state, jnp.zeros((6,), jnp.int32), key, sigma)
        state, counters, _, _ = jax.lax.fori_loop(0, n_steps, _inner(True),
                                                  val)
        return state, counters

    def drain_fn(state, key, sigma):
        val = (state, jnp.zeros((6,), jnp.int32), key, sigma)
        state, counters, _, _ = jax.lax.fori_loop(0, max_it + 1,
                                                  _inner(False), val)
        return state, counters

    return (jax.jit(init_fn), jax.jit(run_fn, donate_argnums=0),
            jax.jit(drain_fn, donate_argnums=0), B)




def _run_binary_stream(code: QCBinaryCode, sim: cfg.BinarySimConfig, mesh,
                       out_dir, checkpoint, quiet) -> SweepResult:
    init_fn, run_fn, drain_fn, B = make_binary_stream_fn(code, sim, mesh)
    sweep = sim.sweep
    d = sim.decoder
    msg_cols = code.L - code.J if d.message_only else code.L
    banner = [
        f" code: {code!r}",
        f" decoder: {d.schedule} "
        f"{'min-sum' if d.rule == 'minsum' else 'sum-product (bp)'}, "
        f"maxIT={d.max_iters}, check={d.check}"
        f"  [STREAMING engine, {sim.stream_steps} iters/call]",
        f" tx: {sim.tx}, noise: {sim.add_noise}, slots: {B} "
        f"({sim.batch_per_device}/device)",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_stream("binary", code.rate, sweep,
                       (init_fn, run_fn, drain_fn), B, 1.0,
                       msg_cols * code.Z, code.k, banner, out_dir,
                       checkpoint, quiet,
                       _config_key(sim, {"kind": "binary_stream", "B": B}))


def run_binary_sweep(sim: cfg.BinarySimConfig, mesh=None,
                     out_dir: str | None = None,
                     checkpoint: str | None = None,
                     quiet: bool = False,
                     profile_dir: str | None = None) -> SweepResult:
    code = QCBinaryCode.from_registry(sim.code)
    if sim.channel == "reference":
        return _run_binary_sweep_ref(code, sim, mesh, out_dir, checkpoint,
                                     quiet)
    if sim.engine == "stream":
        return _run_binary_stream(code, sim, mesh, out_dir, checkpoint,
                                  quiet)
    if sim.engine != "batch":
        raise ValueError(f"unknown engine {sim.engine!r} "
                         "(expected 'batch' or 'stream')")
    fn, B = make_binary_step(code, sim, mesh)
    sweep = sim.sweep
    d = sim.decoder
    _write_logo("binary", [
        f" code: {code!r}",
        f" decoder: {d.schedule} "
        f"{'min-sum' if d.rule == 'minsum' else 'sum-product (bp)'}, "
        f"maxIT={d.max_iters}, "
        f"alpha={d.alpha}, beta={d.beta}, check={d.check}, "
        f"dtype={d.msg_dtype}",
        f" tx: {sim.tx}, noise: {sim.add_noise}, batch: {B} "
        f"({sim.batch_per_device}/device)",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ], out_dir, quiet)
    base = jax.random.PRNGKey(sweep.seed)
    base = jax.random.fold_in(base, jax.process_index())
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L

    def step(si, bi, snr):
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type)
        key = jax.random.fold_in(jax.random.fold_in(base, si), bi)
        out = fn(key, sigma)               # async dispatch

        def collect():
            errbits, errf, falsef, alarmf, iters = (int(x) for x in
                                                    np.asarray(out))
            # batch-global iteration count, weighted per frame like the
            # reference (Simulation.cu:258: Total_Iteration += iteraTime)
            return (B, errf, errbits, iters * B, falsef, alarmf)

        return collect

    key_salt = _config_key(sim, {"kind": "binary", "B": B})
    return _run_sweep("binary", sweep, msg_cols * code.Z, code.k, B, step,
                      out_dir, checkpoint, key_salt, quiet,
                      profile_dir=profile_dir)


def _run_binary_sweep_ref(code, sim: cfg.BinarySimConfig, mesh, out_dir,
                          checkpoint, quiet) -> SweepResult:
    """Binary sweep with the reference's exact deterministic channel (seeds
    reset to (173,173,173) at every SNR point).  Batch size must match the
    reference's Num_Frames_OneTime for sequence-identical batches."""
    fn, B = make_binary_ref_channel_step(code, sim, mesh)
    sweep = sim.sweep
    src = _ref_channel_source(code, B)
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    state = {"si": -1, "produced": 0}

    def step(si, bi, snr):
        if si != state["si"]:          # new SNR point: reset the LCG
            src.reset()
            state["si"] = si
            state["produced"] = 0
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type)
        # checkpoint resume mid-point: fast-forward the sequential LCG past
        # the batches already counted in the restored stats
        while state["produced"] < bi:
            src.next(sigma)
            state["produced"] += 1
        chan = jnp.asarray(src.next(sigma))
        state["produced"] += 1
        out = fn(chan)

        def collect():
            errbits, errf, falsef, alarmf, iters = (int(x) for x in
                                                    np.asarray(out))
            return (B, errf, errbits, iters * B, falsef, alarmf)

        return collect

    key_salt = _config_key(sim, {"kind": "binary_ref", "B": B})
    # pipeline=False: this mode exists to reproduce the reference run
    # bit-exactly, including its up-to-date-stats stop rule
    return _run_sweep("binary", sweep, msg_cols * code.Z, code.k, B, step,
                      out_dir, checkpoint, key_salt, quiet, pipeline=False)


def make_binary_packed_step(code: QCBinaryCode, sim: cfg.BinarySimConfig,
                            n_points: int, mesh=None):
    """Packed multi-SNR step: each frame carries its own sigma and SNR-point
    id; per-point counters come back as a [S, 5] segment-sum.  The reference
    sweeps SNR strictly sequentially (bldpc_实习/main.cu:114-157), leaving the
    device underfilled once a point nears its stop rule; packing keeps every
    lane busy until the LAST point finishes."""
    dec_cfg = sim.decoder
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    decode = _pick_binary_decode(dec_cfg)
    shard = batch_sharding(mesh, 3)
    msg_cols = code.L - code.J if dec_cfg.message_only else code.L
    dtype = jnp.dtype(dec_cfg.msg_dtype)
    enc = None
    if sim.tx == "random":
        from cuda_ldpc_tpu.models.encoder import BinaryEncoder
        enc = BinaryEncoder.from_code(code)
        if dec_cfg.check == "zero":
            raise ValueError("tx='random' needs check='syndrome'")

    def step(key, sigma_vec, pid_vec):
        bp = dec_cfg.rule == "bp"     # sum-product needs true LLRs 2y/sigma^2
        scale_vec = 2.0 / (sigma_vec * sigma_vec) if bp else None
        if enc is None:
            cw = None                 # all-zero codeword, x = +1 everywhere
            x = jnp.ones((B, code.L, code.Z), jnp.float32)
        else:
            kmsg, key = jax.random.split(key)
            msg = jax.random.bernoulli(
                kmsg, 0.5, (B, enc.k_eff)).astype(jnp.float32)
            cw = enc.encode_jax(msg).reshape(B, code.L, code.Z)
            cw = cw.astype(jnp.float32)
            x = 1.0 - 2.0 * cw
        noise = jax.random.normal(key, x.shape, dtype=jnp.float32)
        chan = x + sigma_vec[:, None, None] * noise
        if bp:
            chan = chan * scale_vec[:, None, None]
        chan = jax.lax.with_sharding_constraint(chan, shard)
        res = decode(chan, code, dec_cfg.max_iters, alpha=dec_cfg.alpha,
                     beta=dec_cfg.beta, check=dec_cfg.check, msg_dtype=dtype)
        h = res.hard[:, :msg_cols].astype(jnp.int32)
        ref = 0 if cw is None else cw[:, :msg_cols].astype(jnp.int32)
        errbits = jnp.sum((h != ref).astype(jnp.int32), axis=(1, 2))
        has_err = errbits > 0
        frame_err = (has_err | ~res.ok).astype(jnp.int32)
        false_f = (has_err & res.ok).astype(jnp.int32)
        alarm_f = (~has_err & ~res.ok).astype(jnp.int32)
        ones = jnp.ones_like(errbits)
        # batch-global iteration count per frame, the reference's own
        # iteraTime semantics (Simulation.cu:258); in packed mode the batch
        # mixes SNR points, so high-SNR rows report the shared batch count —
        # use sequential or stream engines for per-point avgIT
        iters = jnp.broadcast_to(res.iters.astype(jnp.int32), ones.shape)
        per_frame = jnp.stack([ones, frame_err, errbits, false_f, alarm_f,
                               iters], axis=1)            # [B, 6]
        return jax.ops.segment_sum(per_frame, pid_vec, num_segments=n_points)

    return jax.jit(step), B


def _run_packed(kind: str, sweep: cfg.SweepConfig, points: list[float],
                sigmas: np.ndarray, fn, B: int, units_per_frame: int,
                info_bits_per_frame: int, out_dir, quiet,
                banner: list[str], checkpoint: str | None = None,
                key_salt: str = "") -> SweepResult:
    """Shared packed-sweep loop: every batch is split over all unfinished SNR
    points; ``fn(key, sigma_vec, pid_vec) -> [S, 6]`` segment-summed counters
    (frames, err_frames, err_units, false, alarm, iter_sum)."""
    base = jax.random.fold_in(jax.random.PRNGKey(sweep.seed),
                              jax.process_index())
    stats = [SnrStats(snr=s, units_per_frame=units_per_frame)
             for s in points]
    ck = _Checkpoint(checkpoint, key_salt) if checkpoint else None
    bi0 = 0
    inflight0 = None
    if ck and ck.state.get("packed"):
        saved = ck.state["packed"]
        stats = [SnrStats.from_checkpoint(d) for d in saved["stats"]]
        bi0 = saved["batch_idx"]
        # the batch that was launched but uncollected at save time: relaunch
        # it with its ORIGINAL point layout so a resumed sweep reproduces the
        # uninterrupted run exactly (the live active set lags one batch)
        inflight0 = saved.get("inflight") or None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _write_logo(kind, banner, out_dir, quiet)

    def unfinished():
        return [i for i, st in enumerate(stats)
                if not (st.error_frames >= sweep.least_error_frames
                        and st.frames >= sweep.least_test_frames)
                and st.frames < sweep.max_frames]

    # one launched batch stays in flight (same pipelining as _run_sweep: the
    # device computes batch k+1 while batch k's counters return to the host;
    # the active set therefore lags one batch, so a finishing point may get
    # one extra — still counted — batch)
    bi = bi0
    consumed = bi0
    pending = None           # (device [S, 6] counters, active point list)
    t_last = time.perf_counter()
    while True:
        active = inflight0 if inflight0 is not None else unfinished()
        inflight0 = None
        nxt = None
        if active:
            # equal split of the batch over active points (deterministic)
            pid = np.asarray(active, dtype=np.int32)[np.arange(B) % len(active)]
            key = jax.random.fold_in(base, bi)
            nxt = (fn(key, jnp.asarray(sigmas[pid]), jnp.asarray(pid)), active)
            bi += 1
        if pending is not None:
            seg_dev, act = pending
            seg = np.asarray(seg_dev)
            now = time.perf_counter()
            secs = now - t_last
            t_last = now
            timed = consumed != bi0   # first batch absorbs compile; untimed
            for i in act:
                nf, ef, eu, ff, af, its = (int(x) for x in seg[i])
                st = stats[i]
                st.frames += nf
                st.error_frames += ef
                st.error_units += eu
                st.false_frames += ff
                st.alarm_frames += af
                st.iter_sum += its
                if timed:
                    st.decode_s += secs * nf / B
                    st.info_bits += nf * info_bits_per_frame
                    st.timed_frames += nf
            consumed += 1
            if ck:
                ck.state["packed"] = {
                    "stats": [dataclasses.asdict(st) for st in stats],
                    "batch_idx": consumed,
                    "inflight": list(nxt[1]) if nxt is not None else None}
                ck.save(None, 0, 0)
        pending = nxt
        if nxt is None:
            break
    rows = []
    for st in stats:
        _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
        rows.append(st.to_dict(kind))
    return SweepResult(rows=rows)


def run_binary_sweep_packed(sim: cfg.BinarySimConfig, mesh=None,
                            out_dir: str | None = None,
                            checkpoint: str | None = None,
                            quiet: bool = False) -> SweepResult:
    """Run ALL SNR points of a binary sweep concurrently in packed batches
    (tx='zero' like the reference, or 'random' via the device encoder)."""
    code = QCBinaryCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    fn, B = make_binary_packed_step(code, sim, len(points), mesh)
    sigmas = np.array([channel.sigma_from_snr(s, code.rate, sweep.snr_type)
                       for s in points], dtype=np.float32)
    msg_cols = code.L - code.J if sim.decoder.message_only else code.L
    banner = [
        f" code: {code!r}  [PACKED multi-SNR sweep, {len(points)} points]",
        f" decoder: {sim.decoder.schedule} "
        f"{'min-sum' if sim.decoder.rule == 'minsum' else 'sum-product (bp)'}, "
        f"maxIT={sim.decoder.max_iters}, check={sim.decoder.check}",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_packed("binary", sweep, points, sigmas, fn, B,
                       msg_cols * code.Z, code.k, out_dir, quiet, banner,
                       checkpoint=checkpoint,
                       key_salt=_config_key(sim, {"kind": "binary_packed",
                                                  "B": B}))


def make_nb_packed_step(code: NBCode, sim: cfg.NBSimConfig, n_points: int,
                        mesh=None):
    """Packed multi-SNR NB step (per-frame sigma; [S, 6] segment counters)."""
    dec = sim.decoder
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    shard = batch_sharding(mesh, 3)
    pts = constellation(sim.n_qam)
    src = _make_nb_source(code, sim, pts, B)
    decoder = _nb_decoder_fn(code, dec)

    def step(key, sigma_vec, pid_vec):
        L, tx = src(key, sigma_vec)
        L = jax.lax.with_sharding_constraint(L, shard)
        res = decoder(L)
        errsyms = jnp.sum((res.hard != tx).astype(jnp.int32), axis=1)
        has_err = errsyms > 0
        per_frame = jnp.stack([
            jnp.ones_like(errsyms), has_err.astype(jnp.int32), errsyms,
            (has_err & res.ok).astype(jnp.int32),
            (~has_err & ~res.ok).astype(jnp.int32),
            res.iters.astype(jnp.int32)], axis=1)
        return jax.ops.segment_sum(per_frame, pid_vec,
                                   num_segments=n_points)

    return jax.jit(step), B


def run_nb_sweep_packed(sim: cfg.NBSimConfig, mesh=None,
                        out_dir: str | None = None,
                        checkpoint: str | None = None,
                        quiet: bool = False) -> SweepResult:
    code = NBCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    fn, B = make_nb_packed_step(code, sim, len(points), mesh)
    bits_per_sym = float(np.log2(sim.n_qam))
    sigmas = np.array([channel.sigma_from_snr(s, code.rate, sweep.snr_type,
                                              bits_per_sym) for s in points],
                      dtype=np.float32)
    banner = [
        f" code: {code!r}  [PACKED multi-SNR sweep, {len(points)} points]",
        f" decoder: {sim.decoder.method}, Nm={sim.decoder.nm}, "
        f"Nc={sim.decoder.nc}, maxIT={sim.decoder.max_iters}",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_packed("nb", sweep, points, sigmas, fn, B, code.n_sym,
                       code.k_sym * code.q_bit, out_dir, quiet, banner,
                       checkpoint=checkpoint,
                       key_salt=_config_key(sim, {"kind": "nb_packed",
                                                  "B": B}))


# --------------------------------------------------------------------------
# non-binary simulator
# --------------------------------------------------------------------------

def _nb_decoder_fn(code: NBCode, dec: cfg.NBDecoderConfig):
    """The jnp NB batch decoder for the configured method."""
    if dec.method not in nb_decode.METHODS:
        raise ValueError(f"unknown NB decoder method {dec.method!r} "
                         f"(expected one of {nb_decode.METHODS})")
    return lambda L: nb_decode.decode(L, code, dec.method, dec.max_iters,
                                      nm=dec.nm, nc=dec.nc)


def _nb_tx(code: NBCode, sim: cfg.NBSimConfig):
    """(labels fed to the modulator, tx symbols) for the configured source."""
    if sim.tx == "fixture":
        tx_syms = registry.load_test_codeword(code.n_sym)
    else:
        tx_syms = np.zeros(code.n_sym, dtype=int)
    if sim.n_qam == 2:
        return demod.sym_to_bit(tx_syms, code.q_bit), tx_syms
    if sim.n_qam != code.q:
        raise ValueError(
            f"QAM order {sim.n_qam} must equal GF order {code.q} "
            "(the reference maps one symbol per constellation point, "
            "myNBLDPC/src/LDPC_Encoder.cpp:19-36)")
    return tx_syms, tx_syms


def _make_nb_source(code: NBCode, sim: cfg.NBSimConfig, pts, B: int):
    """Jit-traceable frame source: (key, sigma) -> (L [B, N, q], tx [B, N]).

    tx='zero' | 'fixture' transmit a constant codeword (the reference's only
    modes — it has no encoder, myNBLDPC/include/codeword_test.h:1);
    tx='random' draws fresh message bits per frame and encodes on device
    (NBEncoder.encode_jax, one bit-sliced matmul).  ``sigma`` may be a
    scalar or a [B] vector (packed sweeps)."""
    if sim.tx == "random":
        if sim.n_qam not in (2, code.q):
            raise ValueError(
                f"QAM order {sim.n_qam} must equal GF order {code.q} "
                "(one symbol per constellation point)")
        from cuda_ldpc_tpu.models.encoder import NBEncoder
        enc = NBEncoder.from_code(code)
        nbits = enc.k_eff * code.q_bit

        def src(key, sigma):
            kmsg, kch = jax.random.split(key)
            mbits = jax.random.bernoulli(
                kmsg, 0.5, (B, nbits)).astype(jnp.float32)
            tx = enc.encode_jax(mbits)                    # [B, N] int32
            L = demod.nb_channel_llr_tx(kch, tx, pts, sigma, code.q)
            return L, tx

        return src
    tx_labels, tx_syms = _nb_tx(code, sim)
    tx_dev = jnp.asarray(tx_syms, dtype=jnp.int32)

    def src(key, sigma):
        L = demod.nb_channel_llr(key, tx_labels, pts, sigma, batch=B,
                                 q=code.q)
        return L, jnp.broadcast_to(tx_dev[None], (B, code.n_sym))

    return src


def make_nb_step(code: NBCode, sim: cfg.NBSimConfig, mesh=None):
    dec = sim.decoder
    mesh = mesh or get_mesh()
    n_dev = mesh.devices.size
    B = sim.batch_per_device * n_dev
    shard = batch_sharding(mesh, 3)
    pts = constellation(sim.n_qam)
    src = _make_nb_source(code, sim, pts, B)
    decoder = _nb_decoder_fn(code, dec)

    def step(key, sigma):
        L, tx = src(key, sigma)
        L = jax.lax.with_sharding_constraint(L, shard)
        res = decoder(L)
        errsyms = jnp.sum((res.hard != tx).astype(jnp.int32), axis=1)
        has_err = errsyms > 0
        false_f = has_err & res.ok
        alarm_f = ~has_err & ~res.ok
        return jnp.stack([jnp.sum(errsyms),
                          jnp.sum(has_err.astype(jnp.int32)),
                          jnp.sum(false_f.astype(jnp.int32)),
                          jnp.sum(alarm_f.astype(jnp.int32)),
                          jnp.sum(res.iters).astype(jnp.int32)])

    return jax.jit(step), B


def make_nb_stream_fn(code: NBCode, sim: cfg.NBSimConfig, mesh=None):
    """Continuous-batching ("streaming") NB decode engine.

    The batch engine decodes each batch until its SLOWEST frame converges —
    at production SNRs a handful of error frames drive the whole batch to
    maxIT while the other ~99% of lanes idle (early termination is
    batch-granular).  Here every decoder iteration
    ends with a per-slot syndrome check: finished slots are counted and
    immediately re-seeded with a fresh frame (new channel draw), so every
    lane does useful work every iteration and throughput tracks the MEAN
    iteration count instead of the batch max.  Statistically identical to
    the batch engine (same channel, decoder, and per-frame iteration
    accounting); no reference counterpart (the reference decodes one frame
    per thread, myNBLDPC/src/Simulation.cpp:16-161).

    Returns (init_fn, run_fn, drain_fn, B):
      init_fn(key, sigma)            -> state
      run_fn(state, key, sigma)      -> (state, counters[6])   # stream_steps iters
      drain_fn(state, key, sigma)    -> (state, counters[6])   # finish in-flight
    counters = [frames, err_frames, err_units, false, alarm, iter_sum].
    The drain pass finishes every in-flight frame WITHOUT refilling — the
    driver must call it at each point's end, otherwise the discarded
    in-flight frames would be biased toward slow/hard frames and FER would
    read low."""
    dec = sim.decoder
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    shard = batch_sharding(mesh, 3)
    pts = constellation(sim.n_qam)
    src = _make_nb_source(code, sim, pts, B)
    core = nb_decode.build_core(code, dec.method, nm=dec.nm, nc=dec.nc)
    g = core.g
    max_it = dec.max_iters
    n_steps = sim.stream_steps

    def fresh(key, sigma):
        L, tx = src(key, sigma)
        L = jax.lax.with_sharding_constraint(L, shard)
        # tx rides in the slot state so per-slot refills splice in each fresh
        # frame's own codeword (constant for tx='zero'/'fixture')
        return (core.init(L), tx)

    def init_fn(key, sigma):
        carry = fresh(key, sigma)
        return (carry, jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool))

    def _inner(refill: bool):
        def inner(i, val):
            ((carry, tx), t, alive), counters, key, sigma = val
            hard, llr = core.decide(carry)
            ok = nb_decode._syndrome_ok(g, hard)
            done = alive & (ok | (t >= max_it))
            errsyms = jnp.sum((hard != tx).astype(jnp.int32), axis=1)
            has_err = errsyms > 0
            di = done.astype(jnp.int32)
            counters = counters + jnp.stack([
                jnp.sum(di),
                jnp.sum(di * has_err.astype(jnp.int32)),
                jnp.sum(di * errsyms),
                jnp.sum(di * (has_err & ok).astype(jnp.int32)),
                jnp.sum(di * (~has_err & ~ok).astype(jnp.int32)),
                jnp.sum(di * t)])
            cont = alive & ~done
            carry = core.step(carry, llr, cont)
            if refill:
                new = fresh(jax.random.fold_in(key, i), sigma)
                carry, tx = jax.tree_util.tree_map(
                    lambda n, o: nb_decode._freeze(done, n, o), new,
                    (carry, tx))
                t = jnp.where(done, 0, t + 1)
            else:
                alive = cont
                t = jnp.where(cont, t + 1, t)
            return ((carry, tx), t, alive), counters, key, sigma
        return inner

    def run_fn(state, key, sigma):
        val = (state, jnp.zeros((6,), jnp.int32), key, sigma)
        state, counters, _, _ = jax.lax.fori_loop(0, n_steps, _inner(True),
                                                  val)
        return state, counters

    def drain_fn(state, key, sigma):
        # every alive frame reaches ok or t == max_it within max_it + 1
        # decide passes (dead slots can't re-trigger: alive &= ~done)
        val = (state, jnp.zeros((6,), jnp.int32), key, sigma)
        state, counters, _, _ = jax.lax.fori_loop(0, max_it + 1,
                                                  _inner(False), val)
        return state, counters

    return (jax.jit(init_fn), jax.jit(run_fn, donate_argnums=0),
            jax.jit(drain_fn, donate_argnums=0), B)




_STREAM_TEST_INTERRUPT: int | None = None   # tests: raise after N consumes


def make_binary_stream_packed_fn(code: QCBinaryCode,
                                 sim: cfg.BinarySimConfig,
                                 sigmas: np.ndarray, mesh=None):
    """Packed multi-SNR continuous batching (binary): every slot carries its
    own SNR-point id; refills adopt the point id the driver assigns per call
    (round-robin over unfinished points), so every lane stays busy until the
    LAST point's stop rule fires — the packed-batch idea (_run_packed)
    compounded with the stream engine.  Drives the jnp BinaryCore with
    per-ITERATION refill: slots refilled during a call adopt the point id
    the driver assigned that call (refill_pid).

    Returns (init_fn, run_fn, drain_fn, B):
      init_fn(key, pid0 [B])              -> state
      run_fn(state, key, refill_pid [B])  -> (state, counters [S, 6])
      drain_fn(state, key)                -> (state, counters [S, 6])
    counters rows = (frames, err_frames, err_units, false, alarm, iter_sum)
    segment-summed by each finished slot's point id."""
    dec = sim.decoder
    if sim.tx == "random" and dec.check == "zero":
        raise ValueError("tx='random' needs check='syndrome'")
    if dec.check == "none":
        raise ValueError("engine='stream' needs a per-frame check")
    mesh = mesh or get_mesh()
    B = sim.batch_per_device * mesh.devices.size
    S = len(sigmas)
    sig_table = jnp.asarray(np.asarray(sigmas, np.float32))
    shard = batch_sharding(mesh, 3)
    flag1 = batch_sharding(mesh, 1)
    core = minsum.build_core(code, rule=dec.rule, schedule=dec.schedule,
                             alpha=dec.alpha, beta=dec.beta,
                             msg_dtype=jnp.dtype(dec.msg_dtype))
    msg_cols = code.L - code.J if dec.message_only else code.L
    enc = None
    if sim.tx == "random":
        from cuda_ldpc_tpu.models.encoder import BinaryEncoder
        enc = BinaryEncoder.from_code(code)
    bp = dec.rule == "bp"
    max_it = dec.max_iters
    n_steps = sim.stream_steps

    def fresh(key, sig):
        if enc is None:
            cw = jnp.zeros((B, code.L, code.Z), jnp.float32)
        else:
            kmsg, key = jax.random.split(key)
            msg = jax.random.bernoulli(
                kmsg, 0.5, (B, enc.k_eff)).astype(jnp.float32)
            cw = enc.encode_jax(msg).reshape(B, code.L, code.Z)
            cw = cw.astype(jnp.float32)
        x = 1.0 - 2.0 * cw
        if sim.add_noise:
            chan = x + sig[:, None, None] * jax.random.normal(
                key, x.shape, dtype=jnp.float32)
        else:
            chan = x
        if bp:
            chan = chan * (2.0 / (sig * sig))[:, None, None]
        chan = jax.lax.with_sharding_constraint(chan, shard)
        return (core.init(chan), cw.astype(jnp.int8))

    def init_fn(key, pid0):
        pid0 = jax.lax.with_sharding_constraint(pid0.astype(jnp.int32),
                                                flag1)
        carry = fresh(key, sig_table[pid0])
        return (carry, jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool),
                pid0)

    def _inner(refill: bool):
        def inner(i, val):
            ((carry, cw), t, alive, pid), counters, key, refill_pid = val
            hard, totals = core.decide(carry)
            ok = minsum._check(code, hard, dec.check)
            done = alive & (ok | (t >= max_it))
            errs = hard[:, :msg_cols].astype(jnp.int32) \
                != cw[:, :msg_cols].astype(jnp.int32)
            errbits = jnp.sum(errs, axis=(1, 2))
            has_err = errbits > 0
            di = done.astype(jnp.int32)
            per = jnp.stack([di, di * has_err.astype(jnp.int32),
                             di * errbits,
                             di * (has_err & ok).astype(jnp.int32),
                             di * (~has_err & ~ok).astype(jnp.int32),
                             di * t], axis=1)
            counters = counters + jax.ops.segment_sum(per, pid,
                                                      num_segments=S)
            cont = alive & ~done
            carry = core.step(carry, totals, cont)
            if refill:
                pid = jnp.where(done, refill_pid, pid)
                new = fresh(jax.random.fold_in(key, i), sig_table[pid])
                carry, cw = jax.tree_util.tree_map(
                    lambda n, o: nb_decode._freeze(done, n, o), new,
                    (carry, cw))
                t = jnp.where(done, 0, t + 1)
            else:
                alive = cont
                t = jnp.where(cont, t + 1, t)
            return ((carry, cw), t, alive, pid), counters, key, refill_pid
        return inner

    def run_fn(state, key, refill_pid):
        val = (state, jnp.zeros((S, 6), jnp.int32), key,
               refill_pid.astype(jnp.int32))
        state, counters, _, _ = jax.lax.fori_loop(0, n_steps, _inner(True),
                                                  val)
        return state, counters

    def drain_fn(state, key):
        val = (state, jnp.zeros((S, 6), jnp.int32), key,
               jnp.zeros((B,), jnp.int32))
        state, counters, _, _ = jax.lax.fori_loop(0, max_it + 1,
                                                  _inner(False), val)
        return state, counters

    return (jax.jit(init_fn), jax.jit(run_fn, donate_argnums=0),
            jax.jit(drain_fn, donate_argnums=0), B)




def make_nb_stream_packed_fn(code: NBCode, sim: cfg.NBSimConfig,
                             sigmas: np.ndarray, mesh=None):
    """Packed multi-SNR continuous batching (non-binary): per-slot SNR-point
    ids over the stream engine (see make_binary_stream_packed_fn for the
    contract): drives the jnp DecoderCore of any method with per-ITERATION
    refill."""
    mesh = mesh or get_mesh()
    dec = sim.decoder
    B = sim.batch_per_device * mesh.devices.size
    S = len(sigmas)
    sig_table = jnp.asarray(np.asarray(sigmas, np.float32))
    shard = batch_sharding(mesh, 3)
    flag1 = batch_sharding(mesh, 1)
    pts = constellation(sim.n_qam)
    src = _make_nb_source(code, sim, pts, B)
    core = nb_decode.build_core(code, dec.method, nm=dec.nm, nc=dec.nc)
    g = core.g
    max_it = dec.max_iters
    n_steps = sim.stream_steps

    def fresh(key, sig):
        L, tx = src(key, sig)
        L = jax.lax.with_sharding_constraint(L, shard)
        return (core.init(L), tx)

    def init_fn(key, pid0):
        pid0 = jax.lax.with_sharding_constraint(pid0.astype(jnp.int32),
                                                flag1)
        carry = fresh(key, sig_table[pid0])
        return (carry, jnp.zeros((B,), jnp.int32), jnp.ones((B,), bool),
                pid0)

    def _inner(refill: bool):
        def inner(i, val):
            ((carry, tx), t, alive, pid), counters, key, refill_pid = val
            hard, llr = core.decide(carry)
            ok = nb_decode._syndrome_ok(g, hard)
            done = alive & (ok | (t >= max_it))
            errsyms = jnp.sum((hard != tx).astype(jnp.int32), axis=1)
            has_err = errsyms > 0
            di = done.astype(jnp.int32)
            per = jnp.stack([di, di * has_err.astype(jnp.int32),
                             di * errsyms,
                             di * (has_err & ok).astype(jnp.int32),
                             di * (~has_err & ~ok).astype(jnp.int32),
                             di * t], axis=1)
            counters = counters + jax.ops.segment_sum(per, pid,
                                                      num_segments=S)
            cont = alive & ~done
            carry = core.step(carry, llr, cont)
            if refill:
                pid = jnp.where(done, refill_pid, pid)
                new = fresh(jax.random.fold_in(key, i), sig_table[pid])
                carry, tx = jax.tree_util.tree_map(
                    lambda n, o: nb_decode._freeze(done, n, o), new,
                    (carry, tx))
                t = jnp.where(done, 0, t + 1)
            else:
                alive = cont
                t = jnp.where(cont, t + 1, t)
            return ((carry, tx), t, alive, pid), counters, key, refill_pid
        return inner

    def run_fn(state, key, refill_pid):
        val = (state, jnp.zeros((S, 6), jnp.int32), key,
               refill_pid.astype(jnp.int32))
        state, counters, _, _ = jax.lax.fori_loop(0, n_steps, _inner(True),
                                                  val)
        return state, counters

    def drain_fn(state, key):
        val = (state, jnp.zeros((S, 6), jnp.int32), key,
               jnp.zeros((B,), jnp.int32))
        state, counters, _, _ = jax.lax.fori_loop(0, max_it + 1,
                                                  _inner(False), val)
        return state, counters

    return (jax.jit(init_fn), jax.jit(run_fn, donate_argnums=0),
            jax.jit(drain_fn, donate_argnums=0), B)




def _run_stream_packed(kind: str, sweep: cfg.SweepConfig,
                       points: list[float], fns, B: int,
                       units_per_frame: int, info_bits_per_frame: int,
                       banner: list[str], out_dir, checkpoint, quiet,
                       key_salt: str) -> SweepResult:
    """Packed multi-SNR streaming sweep driver: one slot pool serves ALL
    unfinished SNR points at once (per-slot point ids; refills assigned
    round-robin over the live unfinished set), with the usual one-call
    pipeline.  Exactly-once accounting: every started frame is counted at
    the call in which its slot finishes, and the final drain finishes
    every in-flight frame (dropping them would censor slow frames and bias
    FER low).  Checkpoint/resume restores counters + slot state and loses
    no frames; unlike the sequential stream driver the post-resume POINT
    ASSIGNMENT of future refills may differ from the uninterrupted run
    (the live unfinished set is consulted at each call), which changes
    which — not how many or how fairly — Monte-Carlo frames each point
    receives."""
    init_fn, run_fn, drain_fn = fns
    _write_logo(kind, banner, out_dir, quiet)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    S = len(points)
    ck = _Checkpoint(checkpoint, key_salt)
    spath = (checkpoint + ".pstate.npz") if checkpoint else None
    done_rows = [ck.done_rows().get(f"{s:g}") for s in points]
    if all(r is not None for r in done_rows):
        return SweepResult(rows=done_rows)      # finished sweep re-run
    base = jax.random.fold_in(jax.random.PRNGKey(sweep.seed),
                              jax.process_index())
    stats = [SnrStats(snr=s, units_per_frame=units_per_frame)
             for s in points]

    def unfinished():
        return [i for i, st in enumerate(stats)
                if not (st.error_frames >= sweep.least_error_frames
                        and st.frames >= sweep.least_test_frames)
                and st.frames < sweep.max_frames]

    state = None
    pending = None
    ci = 1
    saved = ck.state.get("stream_packed")
    if saved and spath and os.path.exists(spath):
        stats = [SnrStats.from_checkpoint(d) for d in saved["stats"]]
        ci = saved["ci"]
        with np.load(spath) as d:
            pending = jnp.asarray(d["pending"])
            leaves = [jnp.asarray(d[f"leaf{i}"])
                      for i in range(d["nleaves"])]
        active0 = unfinished() or [0]
        pid0 = np.asarray(active0, np.int32)[np.arange(B) % len(active0)]
        template = jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                                  jnp.asarray(pid0))
        tdef = jax.tree_util.tree_structure(template)
        state = jax.tree_util.tree_unflatten(tdef, leaves)
    if state is None:
        active0 = unfinished()
        pid0 = np.asarray(active0, np.int32)[np.arange(B) % len(active0)]
        state = init_fn(jax.random.fold_in(base, 0), jnp.asarray(pid0))
    t_last = time.perf_counter()
    t_ckpt = t_last
    first = True
    consumed = 0

    def consume(out, timed=True):
        nonlocal t_last
        seg = np.asarray(out)
        now = time.perf_counter()
        secs = now - t_last
        nf_total = int(seg[:, 0].sum())
        for i in range(S):
            nf, ef, eu, ff, af, its = (int(x) for x in seg[i])
            st = stats[i]
            st.frames += nf
            st.error_frames += ef
            st.error_units += eu
            st.false_frames += ff
            st.alarm_frames += af
            st.iter_sum += its
            if timed and nf_total:
                st.decode_s += secs * nf / nf_total
                st.info_bits += nf * info_bits_per_frame
                st.timed_frames += nf
        t_last = now

    def save_packed(pending_now, ci_now):
        if not spath:
            return
        leaves = jax.tree_util.tree_leaves(state)
        arrs = {f"leaf{i}": np.asarray(x) for i, x in enumerate(leaves)}
        tmp = spath + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, pending=np.asarray(pending_now),
                     nleaves=len(leaves), **arrs)
        os.replace(tmp, spath)
        ck.state["stream_packed"] = {
            "stats": [dataclasses.asdict(st) for st in stats],
            "ci": ci_now}
        ck.save(None, 0, 0)

    while True:
        active = unfinished()
        nxt = None
        if active:
            refill_pid = np.asarray(active,
                                    np.int32)[np.arange(B) % len(active)]
            state, nxt = run_fn(state, jax.random.fold_in(base, ci),
                                jnp.asarray(refill_pid))
            ci += 1
        if pending is not None:
            consume(pending, timed=not first)
            first = False
            consumed += 1
            if (_STREAM_TEST_INTERRUPT is not None and nxt is not None
                    and consumed >= _STREAM_TEST_INTERRUPT):
                save_packed(nxt, ci)
                raise KeyboardInterrupt("packed stream test interrupt")
            now = time.perf_counter()
            if nxt is not None and now - t_ckpt >= sweep.stream_ckpt_s:
                save_packed(nxt, ci)
                t_ckpt = now
        pending = nxt
        if nxt is None:
            break
    state, dout = drain_fn(state, jax.random.fold_in(base, ci))
    consume(dout, timed=False)     # drain absorbs its own jit compile
    rows = []
    for st in stats:
        _emit(st.row(kind), st.to_dict(kind), out_dir, quiet)
        rows.append(st.to_dict(kind))
    if ck.path:
        ck.state.pop("stream_packed", None)
        for st in stats:
            ck.finish_point(st, kind)
    if spath and os.path.exists(spath):
        os.remove(spath)
    return SweepResult(rows=rows)


def run_binary_stream_packed(sim: cfg.BinarySimConfig, mesh=None,
                             out_dir: str | None = None,
                             checkpoint: str | None = None,
                             quiet: bool = False) -> SweepResult:
    """Packed multi-SNR sweep on the binary continuous-batching engine."""
    code = QCBinaryCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    sigmas = np.array([channel.sigma_from_snr(s, code.rate, sweep.snr_type)
                       for s in points], dtype=np.float32)
    fns = make_binary_stream_packed_fn(code, sim, sigmas, mesh)
    init_fn, run_fn, drain_fn, B = fns
    d = sim.decoder
    msg_cols = code.L - code.J if d.message_only else code.L
    banner = [
        f" code: {code!r}  [PACKED STREAMING sweep, {len(points)} points, "
        f"{sim.stream_steps} iters/call]",
        f" decoder: {d.schedule} "
        f"{'min-sum' if d.rule == 'minsum' else 'sum-product (bp)'}, "
        f"maxIT={d.max_iters}, check={d.check}",
        f" tx: {sim.tx}, slots: {B}",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_stream_packed(
        "binary", sweep, points, (init_fn, run_fn, drain_fn), B,
        msg_cols * code.Z, code.k, banner, out_dir, checkpoint, quiet,
        _config_key(sim, {"kind": "binary_stream_packed", "B": B}))


def run_nb_stream_packed(sim: cfg.NBSimConfig, mesh=None,
                         out_dir: str | None = None,
                         checkpoint: str | None = None,
                         quiet: bool = False) -> SweepResult:
    """Packed multi-SNR sweep on the NB continuous-batching engine."""
    code = NBCode.from_registry(sim.code)
    sweep = sim.sweep
    points = sweep.snr_points()
    bits_per_sym = float(np.log2(sim.n_qam))
    sigmas = np.array([channel.sigma_from_snr(s, code.rate, sweep.snr_type,
                                              bits_per_sym) for s in points],
                      dtype=np.float32)
    fns = make_nb_stream_packed_fn(code, sim, sigmas, mesh)
    init_fn, run_fn, drain_fn, B = fns
    d = sim.decoder
    banner = [
        f" code: {code!r}  [PACKED STREAMING sweep, {len(points)} points, "
        f"{sim.stream_steps} iters/call]",
        f" decoder: {d.method}, maxIT={d.max_iters}",
        f" modulation: {'BPSK' if sim.n_qam == 2 else f'{sim.n_qam}-QAM'}, "
        f"tx: {sim.tx}, slots: {B}",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_stream_packed(
        "nb", sweep, points, (init_fn, run_fn, drain_fn), B, code.n_sym,
        code.k_sym * code.q_bit, banner, out_dir, checkpoint, quiet,
        _config_key(sim, {"kind": "nb_stream_packed", "B": B}))


def _run_stream(kind: str, code_rate: float, sweep: cfg.SweepConfig,
                fns, B: int, bits_per_sym: float, units_per_frame: int,
                info_bits_per_frame: int, banner: list[str], out_dir,
                checkpoint, quiet, key_salt: str) -> SweepResult:
    """Shared streaming-engine sweep driver (binary + NB): per SNR point,
    keep one streaming call in flight (same pipelining as _run_sweep), apply
    the stop rule on collected counters, then drain in-flight frames so the
    tally is unbiased.

    Mid-point checkpointing: every ``sweep.stream_ckpt_s`` seconds the
    on-device slot state is fetched and persisted (<checkpoint>.state.npz)
    together with the collected stats, the NEXT call index, and the one
    in-flight call's counters.  A resumed sweep continues the exact call/key
    sequence, so kill + resume reproduces the uninterrupted run's final
    statistics bit-for-bit (no started frame is ever dropped — dropping the
    in-flight call's finished frames would censor fast frames and bias FER
    low)."""
    init_fn, run_fn, drain_fn = fns
    _write_logo(kind, banner, out_dir, quiet)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ck = _Checkpoint(checkpoint, key_salt)
    spath = (checkpoint + ".state.npz") if checkpoint else None
    base = jax.random.fold_in(jax.random.PRNGKey(sweep.seed),
                              jax.process_index())
    rows: list[dict] = []
    drain_first = True
    consumed_calls = 0
    for si, snr in enumerate(sweep.snr_points()):
        done_row = ck.done_rows().get(f"{snr:g}")
        if done_row is not None:
            rows.append(done_row)
            continue
        sigma = channel.sigma_from_snr(snr, code_rate, sweep.snr_type,
                                       bits_per_sym)
        pk = jax.random.fold_in(base, si)
        stats = SnrStats(snr=snr, units_per_frame=units_per_frame)
        state = init_fn(jax.random.fold_in(pk, 0), sigma)
        ci0 = 1
        pending0 = None
        cur = ck.current(snr)
        if cur and cur.get("stream_ci") and spath and os.path.exists(spath):
            # restore: stats + next call index + in-flight counters + the
            # slot state (leaves spliced into a template from init_fn)
            stats = SnrStats.from_checkpoint(cur["stats"])
            ci0 = cur["stream_ci"]
            with np.load(spath) as d:
                pending0 = jnp.asarray(d["pending"])
                leaves = [jnp.asarray(d[f"leaf{i}"])
                          for i in range(d["nleaves"])]
            tdef = jax.tree_util.tree_structure(state)
            state = jax.tree_util.tree_unflatten(tdef, leaves)
        t_last = time.perf_counter()
        t_ckpt = t_last
        first = True           # first consume absorbs (re)compile; untimed
        next_display = (stats.frames // sweep.display_step + 1) \
            * sweep.display_step

        def consume(out, timed=True):
            nonlocal t_last, next_display
            nf, ef, eu, ff, af, its = (int(x) for x in np.asarray(out))
            now = time.perf_counter()
            stats.frames += nf
            stats.error_frames += ef
            stats.error_units += eu
            stats.false_frames += ff
            stats.alarm_frames += af
            stats.iter_sum += its
            if timed:
                stats.decode_s += now - t_last
                stats.info_bits += nf * info_bits_per_frame
                stats.timed_frames += nf
            t_last = now
            if stats.frames >= next_display:
                _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
                next_display = (stats.frames // sweep.display_step + 1) \
                    * sweep.display_step

        def save_stream(pending_now, ci_now):
            if not spath:
                return
            leaves = jax.tree_util.tree_leaves(state)
            arrs = {f"leaf{i}": np.asarray(x) for i, x in enumerate(leaves)}
            tmp = spath + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, pending=np.asarray(pending_now),
                         nleaves=len(leaves), **arrs)
            os.replace(tmp, spath)
            ck.save(stats, 0, units_per_frame, extra={"stream_ci": ci_now})

        pending = pending0
        ci = ci0
        while True:
            state, out = run_fn(state, jax.random.fold_in(pk, ci), sigma)
            ci += 1
            if pending is not None:
                consume(pending, timed=not first)
                first = False
                consumed_calls += 1
                if (_STREAM_TEST_INTERRUPT is not None
                        and consumed_calls >= _STREAM_TEST_INTERRUPT):
                    save_stream(out, ci)
                    raise KeyboardInterrupt("stream test interrupt")
                now = time.perf_counter()
                if now - t_ckpt >= sweep.stream_ckpt_s:
                    save_stream(out, ci)
                    t_ckpt = now
            pending = out
            if ((stats.error_frames >= sweep.least_error_frames
                 and stats.frames >= sweep.least_test_frames)
                    or stats.frames >= sweep.max_frames):
                break
        consume(pending, timed=not first)
        state, out = drain_fn(state, jax.random.fold_in(pk, ci), sigma)
        # the first drain call of the sweep absorbs drain_fn's jit compile,
        # which would otherwise dominate decode_s; frames still count toward
        # FER either way (timed_frames excludes them)
        consume(out, timed=not drain_first)
        drain_first = False
        _emit(stats.row(kind), stats.to_dict(kind), out_dir, quiet)
        ck.finish_point(stats, kind)
        if spath and os.path.exists(spath):
            os.remove(spath)           # state consumed; drop the stale npz
        rows.append(stats.to_dict(kind))
    return SweepResult(rows=rows)


def _run_nb_stream(code: NBCode, sim: cfg.NBSimConfig, mesh, out_dir,
                   checkpoint, quiet) -> SweepResult:
    init_fn, run_fn, drain_fn, B = make_nb_stream_fn(code, sim, mesh)
    sweep = sim.sweep
    d = sim.decoder
    banner = [
        f" code: {code!r}",
        f" decoder: {d.method}, Nm={d.nm}, Nc={d.nc}, maxIT={d.max_iters}"
        f"  [STREAMING engine, {sim.stream_steps} iters/call]",
        f" modulation: {'BPSK' if sim.n_qam == 2 else f'{sim.n_qam}-QAM'}, "
        f"tx: {sim.tx}, slots: {B} ({sim.batch_per_device}/device)",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ]
    return _run_stream("nb", code.rate, sweep, (init_fn, run_fn, drain_fn),
                       B, float(np.log2(sim.n_qam)), code.n_sym,
                       code.k_sym * code.q_bit, banner, out_dir, checkpoint,
                       quiet, _config_key(sim, {"kind": "nb_stream",
                                                "B": B}))


def run_nb_sweep(sim: cfg.NBSimConfig, mesh=None, out_dir: str | None = None,
                 checkpoint: str | None = None,
                 quiet: bool = False,
                 profile_dir: str | None = None) -> SweepResult:
    code = NBCode.from_registry(sim.code)
    if sim.engine == "stream":
        return _run_nb_stream(code, sim, mesh, out_dir, checkpoint, quiet)
    if sim.engine != "batch":
        raise ValueError(f"unknown engine {sim.engine!r} "
                         "(expected 'batch' or 'stream')")
    fn, B = make_nb_step(code, sim, mesh)
    sweep = sim.sweep
    d = sim.decoder
    _write_logo("nb", [
        f" code: {code!r}",
        f" decoder: {d.method}, Nm={d.nm}, Nc={d.nc}, maxIT={d.max_iters}",
        f" modulation: {'BPSK' if sim.n_qam == 2 else f'{sim.n_qam}-QAM'}, "
        f"tx: {sim.tx}, batch: {B} ({sim.batch_per_device}/device)",
        f" sweep: {sweep.snr_type} {sweep.snr_start}:{sweep.snr_step}:"
        f"{sweep.snr_stop}, stop at >={sweep.least_error_frames} errors & "
        f">={sweep.least_test_frames} frames, seed={sweep.seed}",
    ], out_dir, quiet)
    base = jax.random.PRNGKey(sweep.seed)
    base = jax.random.fold_in(base, jax.process_index())
    bits_per_sym = float(np.log2(sim.n_qam))

    def step(si, bi, snr):
        # sigma includes the log2(n_QAM)*rate factor (myNBLDPC/src/main.cu:221-228)
        sigma = channel.sigma_from_snr(snr, code.rate, sweep.snr_type,
                                       bits_per_sym)
        key = jax.random.fold_in(jax.random.fold_in(base, si), bi)
        out = fn(key, sigma)

        def collect():
            errsyms, errf, falsef, alarmf, iters = (int(x) for x in
                                                    np.asarray(out))
            return (B, errf, errsyms, iters, falsef, alarmf)

        return collect

    key_salt = _config_key(sim, {"kind": "nb", "B": B})
    return _run_sweep("nb", sweep, code.n_sym,
                      code.k_sym * code.q_bit, B, step, out_dir, checkpoint,
                      key_salt, quiet, profile_dir=profile_dir)
