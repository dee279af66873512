"""Command-line interface — the runtime replacement for the reference's
compile-time #define configuration (both reference binaries are zero-argument
executables, bldpc_实习/main.cu:9, myNBLDPC/src/main.cu:14; every option below
maps to a macro cited in cuda_ldpc_tpu/config.py).

Usage:
  python -m cuda_ldpc_tpu binary --code J4_L24_Z96 --snr 2:0.2:4 ...
  python -m cuda_ldpc_tpu nb --code BDS.576.288.GF.64 --method ems ...
  python -m cuda_ldpc_tpu list-codes
"""

from __future__ import annotations

import argparse
import sys

from cuda_ldpc_tpu import config as cfg
from cuda_ldpc_tpu.utils import registry


def _parse_snr(spec: str):
    try:
        parts = [float(p) for p in spec.split(":")]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid SNR spec {spec!r}: must be 'x' or 'start:step:stop'")
    if len(parts) == 1:
        return parts[0], 1.0, parts[0]
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    raise argparse.ArgumentTypeError("SNR spec must be 'x' or 'start:step:stop'")


def _add_sweep_args(p, d: cfg.SweepConfig):
    p.add_argument("--snr", default=None, type=_parse_snr,
                   help=f"start:step:stop (default "
                        f"{d.snr_start}:{d.snr_step}:{d.snr_stop})")
    p.add_argument("--snr-type", choices=["ebn0", "esn0"], default=d.snr_type)
    p.add_argument("--least-error-frames", type=int,
                   default=d.least_error_frames)
    p.add_argument("--least-test-frames", type=int, default=d.least_test_frames)
    p.add_argument("--max-frames", type=int, default=d.max_frames)
    p.add_argument("--display-step", type=int, default=d.display_step)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--checkpoint", default=None,
                   help="JSON checkpoint path for resumable sweeps")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="wrap one steady-state batch per SNR point in "
                        "jax.profiler.trace(DIR) (batch engines)")
    p.add_argument("--distributed", action="store_true",
                   help="call jax.distributed.initialize() so the mesh spans "
                        "every host's devices (run one process per host)")


def _sweep_from(args, d: cfg.SweepConfig) -> cfg.SweepConfig:
    s = cfg.SweepConfig(
        snr_type=args.snr_type, least_error_frames=args.least_error_frames,
        least_test_frames=args.least_test_frames, max_frames=args.max_frames,
        display_step=args.display_step, seed=args.seed,
        snr_start=d.snr_start, snr_step=d.snr_step, snr_stop=d.snr_stop)
    if args.snr:
        s.snr_start, s.snr_step, s.snr_stop = args.snr
    return s


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_tpu",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("binary", help="binary QC-LDPC min-sum FER sweep")
    bd = cfg.BinarySimConfig()
    b.add_argument("--code", default=bd.code,
                   choices=registry.BINARY_CODES, metavar="CODE")
    b.add_argument("--schedule", choices=["flooding", "layered"],
                   default=bd.decoder.schedule)
    b.add_argument("--rule", choices=["minsum", "bp"], default=bd.decoder.rule,
                   help="CN update rule: minsum (decoder_method=0) or bp "
                        "(exact sum-product — the reference's declared but "
                        "unimplemented decoder_method=1, define.cuh:33-34)")
    b.add_argument("--max-iters", type=int, default=bd.decoder.max_iters)
    b.add_argument("--alpha", type=float, default=bd.decoder.alpha,
                   help="normalization factor (reference uses 1.0)")
    b.add_argument("--beta", type=float, default=bd.decoder.beta,
                   help="offset min-sum beta")
    b.add_argument("--check", choices=["zero", "syndrome", "none"],
                   default=bd.decoder.check)
    b.add_argument("--count-full-codeword", action="store_true",
                   help="Message_CW=1: count errors over all n bits")
    b.add_argument("--batch", type=int, default=bd.batch_per_device,
                   help="frames per device per decode call")
    b.add_argument("--no-noise", action="store_true", help="Add_noise=0")
    b.add_argument("--channel", choices=["jax", "reference"], default="jax",
                   help="reference: the CUDA reference's exact LCG noise "
                        "sequence (host-generated; batch must equal its "
                        "Num_Frames_OneTime for sequence parity)")
    b.add_argument("--packed", action="store_true",
                   help="run all SNR points concurrently in packed batches "
                        "(per-frame sigma; keeps the device full)")
    b.add_argument("--tx", choices=["zero", "random"], default=bd.tx,
                   help="random: encode random messages (needs "
                        "--check syndrome)")
    b.add_argument("--msg-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    b.add_argument("--engine", choices=["batch", "stream"], default=bd.engine,
                   help="stream: continuous batching — finished frames leave "
                        "their slot immediately (see "
                        "sim.make_binary_stream_fn)")
    b.add_argument("--stream-steps", type=int, default=bd.stream_steps,
                   help="decoder iterations per streaming call")
    _add_sweep_args(b, bd.sweep)

    n = sub.add_parser("nb", help="non-binary GF(q) LDPC FER sweep")
    nd = cfg.NBSimConfig()
    n.add_argument("--code", default=nd.code, choices=registry.NB_CODES,
                   metavar="CODE")
    n.add_argument("--method", default=nd.decoder.method,
                   choices=["ems", "ems_full", "qspa", "layered_qspa",
                            "glayered_qspa", "tmm", "layered_tmm",
                            "glayered_tmm"])
    n.add_argument("--nm", type=int, default=nd.decoder.nm)
    n.add_argument("--nc", type=int, default=nd.decoder.nc)
    n.add_argument("--max-iters", type=int, default=nd.decoder.max_iters)
    n.add_argument("--n-qam", type=int, default=nd.n_qam,
                   choices=[2, 64, 256])
    n.add_argument("--batch", type=int, default=nd.batch_per_device)
    n.add_argument("--tx", choices=["zero", "fixture", "random"],
                   default=nd.tx,
                   help="random: device NBEncoder, fresh codeword per frame")
    n.add_argument("--packed", action="store_true",
                   help="run all SNR points concurrently in packed batches")
    n.add_argument("--engine", choices=["batch", "stream"], default=nd.engine,
                   help="stream: continuous batching — finished frames leave "
                        "their slot immediately and a fresh frame takes it, "
                        "so throughput tracks the MEAN iteration count "
                        "instead of the batch max")
    n.add_argument("--stream-steps", type=int, default=nd.stream_steps,
                   help="decoder iterations per streaming call")
    _add_sweep_args(n, nd.sweep)

    sub.add_parser("list-codes", help="list registered code assets")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "list-codes":
        print("binary QC-LDPC codes:")
        for c in registry.BINARY_CODES:
            print("  ", c)
        print("non-binary GF(q) codes:")
        for c in registry.NB_CODES:
            print("  ", c)
        return 0

    from cuda_ldpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if getattr(args, "distributed", False):
        import jax
        jax.distributed.initialize()

    from cuda_ldpc_tpu import sim as simmod   # defer jax import

    if args.cmd == "binary":
        simcfg = cfg.BinarySimConfig(
            code=args.code,
            decoder=cfg.BinaryDecoderConfig(
                max_iters=args.max_iters, alpha=args.alpha, beta=args.beta,
                rule=args.rule, schedule=args.schedule, check=args.check,
                message_only=not args.count_full_codeword,
                msg_dtype=args.msg_dtype),
            sweep=_sweep_from(args, cfg.BinarySimConfig().sweep),
            batch_per_device=args.batch, add_noise=not args.no_noise,
            tx=args.tx, channel=args.channel, engine=args.engine,
            stream_steps=args.stream_steps)
        if args.packed and args.engine == "stream":
            res = simmod.run_binary_stream_packed(simcfg,
                                                  out_dir=args.out_dir,
                                                  checkpoint=args.checkpoint,
                                                  quiet=args.quiet)
        elif args.packed:
            res = simmod.run_binary_sweep_packed(simcfg, out_dir=args.out_dir,
                                                 checkpoint=args.checkpoint,
                                                 quiet=args.quiet)
        else:
            res = simmod.run_binary_sweep(simcfg, out_dir=args.out_dir,
                                          checkpoint=args.checkpoint,
                                          quiet=args.quiet,
                                          profile_dir=args.profile)
    else:
        simcfg = cfg.NBSimConfig(
            code=args.code,
            decoder=cfg.NBDecoderConfig(method=args.method, nm=args.nm,
                                        nc=args.nc, max_iters=args.max_iters),
            sweep=_sweep_from(args, cfg.NBSimConfig().sweep),
            n_qam=args.n_qam, batch_per_device=args.batch, tx=args.tx,
            engine=args.engine, stream_steps=args.stream_steps)
        if args.packed and args.engine == "stream":
            res = simmod.run_nb_stream_packed(simcfg, out_dir=args.out_dir,
                                              checkpoint=args.checkpoint,
                                              quiet=args.quiet)
        elif args.packed:
            res = simmod.run_nb_sweep_packed(simcfg, out_dir=args.out_dir,
                                             checkpoint=args.checkpoint,
                                             quiet=args.quiet)
        else:
            res = simmod.run_nb_sweep(simcfg, out_dir=args.out_dir,
                                      checkpoint=args.checkpoint,
                                      quiet=args.quiet,
                                      profile_dir=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
