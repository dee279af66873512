"""Smoke test of the simulator on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py              # every phase below, one card
    python chip_smoke.py --cards 4    # only the sharded packed sweep: 4 cards
                                      # against the same global batch on 1

Phases (one process; any failed phase makes the exit code nonzero):

1. device    -- JAX's first device is a GPU; otherwise exit without a result.
2. binary parity at full width -- 64 host-generated frames of J15_L30_Z1280
   and of PON_LDPC decoded by the jnp flooding and layered min-sum on the GPU
   and on the CPU device of the same process: hard/ok/iters bit-identical.
   ``rule='bp'`` (tanh/log) must give identical decisions in >= 99.9 % of
   frames (the transcendental functions differ between backends in the last
   ulp, so only the decisions are compared).
3. binary deployments through the CLI -- the flagship (J15_L30_Z1280,
   B=4096, 10 iterations) at one waterfall point and the reference's PON_LDPC
   deployment cut to its waterfall points (packed, B=4096, maxIT 50); each
   FER must be compatible with its recorded anchor (overlapping 99.9 %
   Clopper-Pearson intervals, utils/stats.rates_compatible).  The flagship's
   anchor is a regression anchor (see ``ANCHORS``).
4. NB -- GPU-vs-CPU parity on 64 frames: EMS (Nm=2, Nc=2) and TMM on
   BDS.576.288.GF.64 bit-exact (max-domain arithmetic with exact one-hot
   permutations); layered_qspa on BDS and glayered_qspa on
   Tanner_74_9_Z128_GF16 within the QSPA tolerance (see ``compare_tolerant``).
   Then the reference NB deployment (EMS, B=1024) and a layered_qspa stream
   sweep through the CLI, each FER against its anchor.
5. encoder + stream engine -- ``binary --tx random --check syndrome --engine
   stream`` on J8_L24_Z96 against its anchor, and both device encoders
   bit-exact against their NumPy encoders.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PARITY_FRAMES = 64

# Recorded FER anchors: (errors, frames, source).  Where the source gives a
# rate and an error count only, frames = errors / rate; where it gives a
# rate and a lower bound on frames, the bound is used (a wider interval).
# Every anchor but the flagship's was recorded before the GPU path existed.
# The flagship's was recorded by this same jnp decoder on an H100 (seed 2026;
# the check below runs seed 7), so it is a regression anchor only: its
# correctness rests on the GPU-vs-CPU bit-parity of phase 2.
ANCHORS = {
    "flagship_3.2": (331, 167936, "VALIDATION.md, J15_L30_Z1280 flooding "
                     "maxIT 10 @ 3.2 dB Eb/N0: 1.971e-03 (331 errors; "
                     "regression anchor, H100)"),
    "pon_2.4": (2330, 10000, "VALIDATION.md, PON_LDPC @ 2.4 dB Es/N0: "
                "0.233 over >= 10000 frames"),
    "pon_2.6": (50, 82919, "VALIDATION.md, PON_LDPC @ 2.6 dB Es/N0: "
                "6.03e-4, 50 errors"),
    "pon_2.8": (0, 200000, "VALIDATION.md, PON_LDPC @ 2.8 dB Es/N0: "
                "0 in 200k frames"),
    "ems_3.0": (105, 2048, "VALIDATION.md, BDS GF(64) ems @ 3 dB: "
                "5.127e-02 (2048f)"),
    "layered_qspa_2.0": (51, 38912, "VALIDATION.md, BDS GF(64) "
                         "layered_qspa @ 2 dB: 1.311e-03 (38912f)"),
    "j8_random_2.53": (360, 32768, "VALIDATION.md, J8_L24_Z96 --tx random "
                       "@ 2.53 dB Eb/N0: 1.099e-02 (360 errors)"),
}


# --------------------------------------------------------------------------
# comparison helpers (pure NumPy; tests/test_chip_smoke.py covers them)
# --------------------------------------------------------------------------

def compare_exact(a, b) -> dict:
    """Bit-identity of two decode results (hard, ok, iters)."""
    return {"hard": bool(np.array_equal(np.asarray(a.hard),
                                        np.asarray(b.hard))),
            "ok": bool(np.array_equal(np.asarray(a.ok), np.asarray(b.ok))),
            "iters": bool(np.array_equal(np.asarray(a.iters),
                                         np.asarray(b.iters)))}


def frame_agreement(a, b) -> float:
    """Share of frames whose hard decisions are identical."""
    ha = np.asarray(a.hard).reshape(len(np.asarray(a.ok)), -1)
    hb = np.asarray(b.hard).reshape(ha.shape)
    return float(np.mean(np.all(ha == hb, axis=1)))


def compare_tolerant(a, b) -> dict:
    """QSPA tolerance.  Summation order and exp/log differ between the GPU
    and the CPU, so a frame that has not converged may drift by ulps into
    different decisions or a different stopping iteration.  A frame whose
    check passes on both is anchored by the discrete syndrome, so:

    * every frame that passes its check on both devices has identical
      decisions;
    * ok flags agree on at least 95 % of frames;
    * iteration counts differ by at most 1 on at least 90 % of frames."""
    ok_a, ok_b = np.asarray(a.ok), np.asarray(b.ok)
    ha = np.asarray(a.hard).reshape(len(ok_a), -1)
    hb = np.asarray(b.hard).reshape(ha.shape)
    both = ok_a & ok_b
    conv_same = bool(np.all(np.all(ha == hb, axis=1)[both]))
    ok_agree = float(np.mean(ok_a == ok_b))
    di = np.abs(np.asarray(a.iters).astype(np.int64)
                - np.asarray(b.iters).astype(np.int64))
    it_close = float(np.mean(np.broadcast_to(di, ok_a.shape) <= 1))
    return {"converged_identical": conv_same, "ok_agree": ok_agree,
            "iters_within_1": it_close,
            "pass": conv_same and ok_agree >= 0.95 and it_close >= 0.90}


def fer_check(errors: int, frames: int, anchor: str) -> dict:
    """FER of a run against its recorded anchor (overlapping 99.9 %
    Clopper-Pearson intervals)."""
    from cuda_ldpc_tpu.utils.stats import clopper_pearson, rates_compatible

    ae, af, src = ANCHORS[anchor]
    lo, hi = clopper_pearson(errors, frames, 0.999)
    alo, ahi = clopper_pearson(ae, af, 0.999)
    return {"errors": errors, "frames": frames, "fer": errors / frames,
            "ci": [lo, hi], "anchor": anchor, "anchor_fer": ae / af,
            "anchor_ci": [alo, ahi], "source": src,
            "pass": rates_compatible(errors, frames, ae, af, 0.999)}


def gpu_identity() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

class Smoke:
    def __init__(self):
        import jax

        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.failed: list[str] = []

    def phase(self, name, fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            ok = False
        dt = time.perf_counter() - t0
        print(f"== phase {name}: {'PASS' if ok else 'FAIL'} ({dt:.1f} s)",
              flush=True)
        if not ok:
            self.failed.append(name)

    def on_both(self, fn, *host_args):
        """Run one jitted function on the GPU and on the CPU device."""
        import jax

        return [jax.block_until_ready(fn(*[jax.device_put(a, dev)
                                           for a in host_args]))
                for dev in (self.gpu, self.cpu)]

    # -- phase 2 ----------------------------------------------------------

    def binary_parity(self) -> bool:
        import functools

        import jax

        from cuda_ldpc_tpu import QCBinaryCode
        from cuda_ldpc_tpu.ops import channel, minsum

        cases = [("J15_L30_Z1280", 3.2, "ebn0", 10),
                 ("PON_LDPC", 2.6, "esn0", 50)]
        good = True
        for name, snr, snr_type, iters in cases:
            code = QCBinaryCode.from_registry(name)
            sigma = channel.sigma_from_snr(snr, code.rate, snr_type)
            rng = np.random.default_rng(20261016)
            chan = (1.0 + sigma * rng.standard_normal(
                (PARITY_FRAMES, code.L, code.Z))).astype(np.float32)
            for decode in (minsum.decode_flooding, minsum.decode_layered):
                fn = jax.jit(functools.partial(decode, code=code,
                                               num_iters=iters,
                                               check="syndrome"))
                g, c = self.on_both(fn, chan)
                res = compare_exact(g, c)
                ok = all(res.values())
                good &= ok
                print(f"  {name} {decode.__name__} minsum @{snr} {snr_type}"
                      f" iters={int(g.iters)} ok={int(np.sum(g.ok))}/"
                      f"{PARITY_FRAMES} exact={res} -> "
                      f"{'PASS' if ok else 'FAIL'}", flush=True)
            if name == "J15_L30_Z1280":
                llr = chan * np.float32(2.0 / (sigma * sigma))
                fn = jax.jit(functools.partial(
                    minsum.decode_flooding, code=code, num_iters=iters,
                    check="syndrome", rule="bp"))
                g, c = self.on_both(fn, llr)
                agree = frame_agreement(g, c)
                ok = agree >= 0.999
                good &= ok
                print(f"  {name} decode_flooding bp @{snr} {snr_type} "
                      f"frames identical {agree:.4f} (need >= 0.999), "
                      f"exact={compare_exact(g, c)} -> "
                      f"{'PASS' if ok else 'FAIL'}", flush=True)
        return good

    # -- CLI helpers --------------------------------------------------------

    def cli_rows(self, argv: list[str]) -> list[dict]:
        from cuda_ldpc_tpu import cli

        with tempfile.TemporaryDirectory() as out:
            rc = cli.main(argv + ["--out-dir", out, "--quiet",
                                  "--display-step", str(10 ** 12)])
            if rc != 0:
                raise RuntimeError(f"cli.main returned {rc}")
            with open(os.path.join(out, "results.jsonl")) as f:
                rows = [json.loads(line) for line in f]
        final = {}
        for r in rows:                  # last row per SNR point
            final[r["snr"]] = r
        return [final[s] for s in sorted(final)]

    def check_rows(self, rows, anchors: dict) -> bool:
        good = True
        for r in rows:
            chk = fer_check(r["error_frames"], r["frames"],
                            anchors[round(r["snr"], 2)])
            good &= chk["pass"]
            print(f"  SNR {r['snr']:.2f}: frames {r['frames']} errors "
                  f"{r['error_frames']} FER {chk['fer']:.4e} "
                  f"CI99.9 [{chk['ci'][0]:.3e}, {chk['ci'][1]:.3e}] avgIT "
                  f"{r['avg_iters']:.2f} info {r['info_mbps']:.1f} Mb/s | "
                  f"anchor {chk['anchor_fer']:.4e} [{chk['anchor_ci'][0]:.3e},"
                  f" {chk['anchor_ci'][1]:.3e}] ({chk['source']}) -> "
                  f"{'PASS' if chk['pass'] else 'FAIL'}", flush=True)
        return good

    # -- phase 3 ----------------------------------------------------------

    def binary_cli(self) -> bool:
        flagship = self.cli_rows([
            "binary", "--code", "J15_L30_Z1280", "--batch", "4096",
            "--max-iters", "10", "--snr", "3.2", "--snr-type", "ebn0",
            "--least-error-frames", "100", "--least-test-frames", "8192",
            "--max-frames", "16384", "--seed", "7"])
        ok = self.check_rows(flagship, {3.2: "flagship_3.2"})
        pon = self.cli_rows([
            "binary", "--code", "PON_LDPC", "--packed", "--batch", "4096",
            "--max-iters", "50", "--snr", "2.4:0.2:2.8",
            "--least-error-frames", "50", "--least-test-frames", "10000",
            "--max-frames", "61440"])
        ok &= self.check_rows(pon, {2.4: "pon_2.4", 2.6: "pon_2.6",
                                    2.8: "pon_2.8"})
        return ok

    # -- phase 4 ----------------------------------------------------------

    def nb_parity(self) -> bool:
        import functools

        import jax

        from cuda_ldpc_tpu import NBCode
        from cuda_ldpc_tpu.ops import channel, demod, nb_decode
        from cuda_ldpc_tpu.utils.constellations import constellation

        cases = [("BDS.576.288.GF.64", "ems", 3.0, 20, True),
                 ("BDS.576.288.GF.64", "tmm", 3.0, 20, True),
                 ("BDS.576.288.GF.64", "layered_qspa", 2.0, 20, False),
                 ("Tanner_74_9_Z128_GF16", "glayered_qspa", 4.5, 10, False)]
        good = True
        for name, method, snr, iters, exact in cases:
            code = NBCode.from_registry(name)
            sigma = channel.sigma_from_snr(snr, code.rate, "ebn0", 1.0)
            with jax.default_device(self.cpu):
                L = np.asarray(demod.nb_channel_llr(
                    jax.random.PRNGKey(1016), np.zeros(code.bit_length, int),
                    constellation(2), sigma, batch=PARITY_FRAMES, q=code.q))
            fn = jax.jit(functools.partial(nb_decode.decode, code=code,
                                           method=method, max_iters=iters,
                                           nm=2, nc=2))
            g, c = self.on_both(fn, L)
            if exact:
                res = compare_exact(g, c)
                ok = all(res.values())
            else:
                res = compare_tolerant(g, c)
                ok = res["pass"]
            good &= ok
            print(f"  {name} {method} @{snr} dB: ok={int(np.sum(g.ok))}/"
                  f"{PARITY_FRAMES} mean iters={float(np.mean(g.iters)):.2f}"
                  f" {'exact' if exact else 'tolerant'}={res} -> "
                  f"{'PASS' if ok else 'FAIL'}", flush=True)
        return good

    def nb_cli(self) -> bool:
        ems = self.cli_rows([
            "nb", "--code", "BDS.576.288.GF.64", "--method", "ems", "--nm",
            "2", "--nc", "2", "--max-iters", "20", "--batch", "1024",
            "--snr", "3.0", "--least-error-frames", "50",
            "--least-test-frames", "4096", "--max-frames", "16384"])
        ok = self.check_rows(ems, {3.0: "ems_3.0"})
        stream = self.cli_rows([
            "nb", "--code", "BDS.576.288.GF.64", "--method", "layered_qspa",
            "--engine", "stream", "--max-iters", "20", "--batch", "1024",
            "--snr", "2.0", "--least-error-frames", "50",
            "--least-test-frames", "40000", "--max-frames", "200000"])
        ok &= self.check_rows(stream, {2.0: "layered_qspa_2.0"})
        return ok

    # -- phase 5 ----------------------------------------------------------

    def encoder_stream(self) -> bool:
        import jax

        from cuda_ldpc_tpu import NBCode, QCBinaryCode
        from cuda_ldpc_tpu.models.encoder import BinaryEncoder, NBEncoder

        rows = self.cli_rows([
            "binary", "--code", "J8_L24_Z96", "--tx", "random", "--check",
            "syndrome", "--engine", "stream", "--batch", "4096",
            "--snr", "2.53", "--snr-type", "ebn0",
            "--least-error-frames", "100", "--least-test-frames", "32768",
            "--max-frames", "131072"])
        ok = self.check_rows(rows, {2.53: "j8_random_2.53"})

        rng = np.random.default_rng(5)
        benc = BinaryEncoder.from_code(QCBinaryCode.from_registry(
            "J8_L24_Z96"))
        msg = rng.integers(0, 2, size=(512, benc.k_eff)).astype(np.uint8)
        dev = np.asarray(jax.jit(benc.encode_jax)(
            jax.device_put(msg.astype(np.float32), self.gpu)))
        same = bool(np.array_equal(dev, benc.encode(msg).astype(np.int8)))
        print(f"  BinaryEncoder J8_L24_Z96 GPU vs NumPy on 512 messages: "
              f"{'bit-exact' if same else 'MISMATCH'}", flush=True)
        ok &= same

        nbc = NBCode.from_registry("BDS.576.288.GF.64")
        nenc = NBEncoder.from_code(nbc)
        syms = rng.integers(0, nbc.q, size=(512, nenc.k_eff))
        bits = ((syms[..., None] >> np.arange(nbc.q_bit)) & 1).reshape(
            512, -1).astype(np.float32)
        dev = np.asarray(jax.jit(nenc.encode_jax)(
            jax.device_put(bits, self.gpu)))
        same = bool(np.array_equal(dev, nenc.encode(syms)))
        print(f"  NBEncoder BDS GF(64) GPU vs NumPy on 512 messages: "
              f"{'bit-exact' if same else 'MISMATCH'}", flush=True)
        return ok and same

    # -- --cards 4 ----------------------------------------------------------

    def sharded_sweep(self, n_cards: int) -> bool:
        import jax

        from cuda_ldpc_tpu import config as cfg, sim
        from cuda_ldpc_tpu.parallel import batch_sharding, get_mesh

        devices = jax.devices()
        if len(devices) < n_cards:
            print(f"  need {n_cards} GPUs, found {len(devices)}", flush=True)
            return False
        per_card = 2048

        def sweep(n):
            return cfg.BinarySimConfig(
                code="PON_LDPC",
                decoder=cfg.BinaryDecoderConfig(max_iters=50),
                sweep=cfg.SweepConfig(
                    snr_start=2.4, snr_step=0.2, snr_stop=2.8,
                    snr_type="esn0", least_error_frames=50,
                    least_test_frames=10000, max_frames=4 * 8192,
                    display_step=10 ** 12, seed=11),
                batch_per_device=per_card * n_cards // n)

        rows = {}
        peaks = []
        for n in (n_cards, 1):
            mesh = get_mesh(devices[:n])
            t0 = time.perf_counter()
            res = sim.run_binary_sweep_packed(sweep(n), mesh=mesh,
                                              quiet=True)
            dt = time.perf_counter() - t0
            if n == n_cards:            # before the 1-card run adds to card 0
                peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                         for d in devices[:n_cards]]
            rows[n] = [(r["snr"], r["frames"], r["error_frames"],
                        r["error_units"], r["iter_sum"], r["false_frames"],
                        r["alarm_frames"]) for r in res.rows]
            for r in res.rows:
                print(f"  {n} card(s) SNR {r['snr']:.1f}: frames "
                      f"{r['frames']} errors {r['error_frames']} bits "
                      f"{r['error_units']} iter_sum {r['iter_sum']} "
                      f"FER {r['fer']:.4e}", flush=True)
            print(f"  {n} card(s): sweep {dt:.1f} s (compile included)",
                  flush=True)
        same = rows[n_cards] == rows[1]
        print(f"  counters {n_cards} cards vs 1 card: "
              f"{'identical' if same else 'DIFFERENT'}", flush=True)

        mesh = get_mesh(devices[:n_cards])
        x = jax.device_put(np.zeros((per_card * n_cards, 4, 4), np.float32),
                           batch_sharding(mesh, 3))
        shard_devs = {s.device for s in x.addressable_shards}
        spread = len(shard_devs) == n_cards and min(peaks) >= 0.5 * max(peaks)
        print(f"  shards on {len(shard_devs)} distinct devices; peak bytes "
              f"per card {peaks} -> {'PASS' if spread else 'FAIL'}",
              flush=True)
        return same and spread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the sharded packed sweep on four cards "
                         "and its one-card comparison")
    args = ap.parse_args(argv)
    # the parity phases compare against JAX's CPU device in this process
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform!r})",
              file=sys.stderr)
        return 3
    for line in gpu_identity().splitlines():
        print(f"card: {line}", flush=True)

    from cuda_ldpc_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smoke = Smoke()
    print(f"device: {dev.device_kind} x{len(jax.devices())}", flush=True)
    t0 = time.perf_counter()
    if args.cards == 4:
        smoke.phase("sharded_sweep_4_cards", lambda: smoke.sharded_sweep(4))
    else:
        smoke.phase("binary_parity", smoke.binary_parity)
        smoke.phase("binary_cli", smoke.binary_cli)
        smoke.phase("nb_parity", smoke.nb_parity)
        smoke.phase("nb_cli", smoke.nb_cli)
        smoke.phase("encoder_stream", smoke.encoder_stream)
    print(f"total {time.perf_counter() - t0:.1f} s; failed phases: "
          f"{smoke.failed or 'none'}", flush=True)
    if smoke.failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
