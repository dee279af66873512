"""Runtime configuration dataclasses.

The reference bakes every parameter in at compile time as #define macros
(bldpc_实习/define.cuh:20-61, myNBLDPC/include/define.h:23-61) — changing the
code under test means editing a header and recompiling.  These dataclasses map
1:1 to those macros so every shipped configuration is expressible at runtime
(see each field's citation), plus the handful of knobs this implementation
adds (batch size per device, dtype, engine).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class SweepConfig:
    """SNR sweep + stop rule, shared by both simulators.

    snr_start/step/stop: define.cuh:48-50 (binary: 0:0.2:13 Es/N0) and
    define.h:48-50 (NB: 0:0.5:5 Eb/N0).  snr_type: snrtype macro (0=ebn0,
    1=esn0).  least_*: the stop rule 'errors >= least_error_frames AND frames
    >= least_test_frames' (define.cuh:52-53, define.h:52-53).  display_step:
    progress-row frequency (define.cuh:54, define.h:54)."""
    snr_start: float = 0.0
    snr_step: float = 0.5
    snr_stop: float = 5.0
    snr_type: str = "ebn0"            # 'ebn0' | 'esn0'
    least_error_frames: int = 50
    least_test_frames: int = 1000
    max_frames: int = 10_000_000      # hard cap the reference lacks
    display_step: int = 10000
    seed: int = 173                   # ix/iy/iz_define collapse to one PRNG seed
    # streaming engines: seconds between mid-point state checkpoints (the
    # slot state is fetched to <checkpoint>.state.npz so a killed sweep
    # resumes mid-point with identical final statistics; sim._run_stream)
    stream_ckpt_s: float = 60.0

    def snr_points(self) -> list[float]:
        pts = []
        s = self.snr_start
        # float accumulation like the reference's `for (SNR += step)` loop
        while s <= self.snr_stop + 1e-9:
            pts.append(round(s, 6))
            s += self.snr_step
        return pts


@dataclasses.dataclass
class BinaryDecoderConfig:
    """Binary min-sum decoder (bldpc_实习).

    max_iters: maxIT (define.cuh:35).  alpha/beta: normalized/offset min-sum —
    the reference applies NO factor (opt_R commented out, define.cuh:36), so
    alpha=1, beta=0 reproduces it.  check: 'zero' is the reference's
    all-zero-message early stop (LDPC_Decoder.cu:137-153, Message_CW=0),
    'syndrome' the true parity check.  schedule: 'flooding' (the reference's
    only schedule) or 'layered'.  rule: 'minsum' (decoder_method=0, the
    reference's only implemented decoder) or 'bp' (exact sum-product —
    decoder_method=1, declared in define.cuh:33-34 but unimplemented there;
    the sim scales the channel to true LLRs 2y/sigma^2 for it)."""
    max_iters: int = 50
    alpha: float = 1.0
    beta: float = 0.0
    rule: str = "minsum"              # 'minsum' | 'bp'
    schedule: str = "flooding"        # 'flooding' | 'layered'
    check: str = "zero"               # 'zero' | 'syndrome' | 'none'
    message_only: bool = True         # Message_CW=0 (define.cuh:61)
    msg_dtype: str = "float32"


@dataclasses.dataclass
class NBDecoderConfig:
    """Non-binary decoder (myNBLDPC).

    method: decoder_method 0/1/2/3 -> ems/tmm/ems_full/layered_tmm
    (define.h:37, Simulation.cpp:56-69), plus 'qspa' / 'layered_qspa' — the
    exact FFT/Hadamard-domain sum-product, flooding or row-layered schedule
    (no reference counterpart).
    nm/nc: EMS_NM/EMS_NC (define.h:31-32).  max_iters: maxIT (define.h:35)."""
    method: str = "ems"
    nm: int = 2
    nc: int = 2
    max_iters: int = 20


@dataclasses.dataclass
class BinarySimConfig:
    code: str = "J4_L24_Z96"          # BlockH registry name (define.cuh dims)
    decoder: BinaryDecoderConfig = dataclasses.field(
        default_factory=BinaryDecoderConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=lambda: SweepConfig(
        snr_start=0.0, snr_step=0.2, snr_stop=13.0, snr_type="esn0",
        least_error_frames=50, least_test_frames=10000))
    batch_per_device: int = 4096      # Num_Frames_OneTime (define.cuh:60)
    add_noise: bool = True            # Add_noise (define.cuh:44)
    tx: str = "zero"                  # 'zero' (the reference's only mode) or
                                      # 'random' (real encoder + syndrome check)
    channel: str = "jax"              # 'jax' (device threefry) or 'reference'
                                      # (the CUDA reference's exact host LCG
                                      # noise sequence, seeds reset per SNR
                                      # point like bldpc_实习/main.cu:117-119)
    # engine: 'batch' decodes whole batches until every frame converges (the
    # reference's host loop, bldpc_实习/LDPC_Decoder.cu:94-156); 'stream' is
    # the continuous-batching engine — finished frames leave their slot
    # immediately (see sim.make_binary_stream_fn).
    engine: str = "batch"             # 'batch' | 'stream'
    stream_steps: int = 16            # decoder iterations per streaming call


@dataclasses.dataclass
class NBSimConfig:
    code: str = "BDS.576.288.GF.64"   # Matrixfile (define.h:23)
    decoder: NBDecoderConfig = dataclasses.field(
        default_factory=NBDecoderConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=SweepConfig)
    n_qam: int = 2                    # n_QAM (define.h:25): 2 | 64 | 256
    batch_per_device: int = 256
    tx: str = "zero"                  # 'zero' | 'fixture' (codeword_test.h) |
                                      # 'random' (device NBEncoder per frame)
    # engine: 'batch' decodes whole batches to the slowest frame's iteration
    # count (like the reference); 'stream' is the continuous-batching engine —
    # finished frames leave their batch slot immediately and a fresh frame
    # takes it, so every lane always does useful work (no reference
    # counterpart; see sim.make_nb_stream_fn).
    engine: str = "batch"             # 'batch' | 'stream'
    stream_steps: int = 16            # decoder iterations per streaming call
