"""Binary min-sum belief propagation on the lifted circulant structure (pure jnp).

Flooding schedule reproduces the numerics of the reference's kernel pair
(bldpc_实习/LDPC_Decoder.cu:172-315): VN total = channel LLR + sum of incident
c2v, hard decision ``total < 0``, v2c = total - c2v; CN two-min with sign
product, writing min2 on the (first) min edge and min1 elsewhere, with NO
normalization factor by default (opt_R exists only as a commented-out macro,
define.cuh:36).  ``alpha``/``beta`` expose normalized/offset min-sum on top.

Early termination runs on-device inside ``lax.while_loop`` (the reference copies
all decisions to the host every iteration, LDPC_Decoder.cu:134-153):

* ``check='syndrome'`` — true parity check H d == 0 (works for any codeword),
* ``check='zero'``     — decoded message bits all zero, the reference's actual
  rule (valid only for its all-zero-codeword simulations).

Message tensors are ``[batch, edge, Z]`` with the circulant as ``jnp.roll``
along the trailing (lane) axis; no gathers/scatters in the hot loop.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode


class DecodeResult(NamedTuple):
    hard: jax.Array       # [B, L, Z] int8 hard decisions
    ok: jax.Array         # [B] bool — early-termination check passed
    iters: jax.Array      # scalar int32 — iterations executed (batch-global)


def _row_stack(code: QCBinaryCode, Q: jax.Array, j: int) -> jax.Array:
    """Column-aligned edge messages of block-row j -> row-aligned [B, dc, Z]."""
    edges = code.edges
    idx = code.row_edges[j]
    return jnp.stack(
        [jnp.roll(Q[:, e], -int(edges[e, 2]), axis=-1) for e in idx], axis=1)


def _cn_minsum(Qr: jax.Array, alpha: float, beta: float) -> jax.Array:
    """Two-min + sign-product CN update on row-aligned messages [B, dc, Z]."""
    dc = Qr.shape[1]
    sgn = jnp.where(Qr < 0, -1.0, 1.0).astype(Qr.dtype)
    mag = jnp.abs(Qr)
    sign_prod = jnp.prod(sgn, axis=1, keepdims=True)
    min1 = jnp.min(mag, axis=1, keepdims=True)
    amin = jnp.argmin(mag, axis=1)                       # first min, like sortQ+scan
    is_min = jax.nn.one_hot(amin, dc, axis=1, dtype=bool)
    big = jnp.asarray(jnp.finfo(Qr.dtype).max, Qr.dtype)
    min2 = jnp.min(jnp.where(is_min, big, mag), axis=1, keepdims=True)
    out = jnp.where(is_min, min2, min1)
    if beta:
        out = jnp.maximum(out - jnp.asarray(beta, Qr.dtype), 0)
    if alpha != 1.0:
        out = out * jnp.asarray(alpha, Qr.dtype)
    return sign_prod * sgn * out


def _cn_bp(Qr: jax.Array, alpha: float, beta: float) -> jax.Array:
    """Exact sum-product CN update (tanh rule) on row-aligned [B, dc, Z]:
    the reference's *declared but never implemented* decoder_method=1 "BP"
    (bldpc_实习/define.cuh:33-34, dispatch banner Simulation.cu:196-205).
    Stable sign/magnitude form  R_i = prod(sgn) * sgn_i * phi(sum_j phi|Q_j|
    - phi|Q_i|)  with the self-inverse phi(x) = -log(tanh(x/2)).

    Unlike min-sum, BP is NOT scale-invariant: Qr must be true LLRs 2y/sigma^2
    (the sim driver applies the scale), not the raw channel samples the
    reference feeds its min-sum (LDPC_Decoder.cu:203)."""
    dtype = Qr.dtype
    sgn = jnp.where(Qr < 0, -1.0, 1.0).astype(dtype)
    sign_prod = jnp.prod(sgn, axis=1, keepdims=True)
    # |LLR| clipped to [1.4e-7, 34]: phi saturates to [0, ~16] either side in
    # f32, keeping phi(sum - phi_i) finite without inf-inf NaNs
    mag = jnp.clip(jnp.abs(Qr), 1.4e-7, 34.0)
    ph = -jnp.log(jnp.tanh(mag * jnp.asarray(0.5, dtype)))
    rest = jnp.sum(ph, axis=1, keepdims=True) - ph
    out = -jnp.log(jnp.tanh(jnp.clip(rest, 1.4e-7, None) * jnp.asarray(0.5, dtype)))
    if beta:
        out = jnp.maximum(out - jnp.asarray(beta, dtype), 0)
    if alpha != 1.0:
        out = out * jnp.asarray(alpha, dtype)
    return sign_prod * sgn * out


_CN_RULES = {"minsum": _cn_minsum, "bp": _cn_bp}


def _vn_update(code: QCBinaryCode, chan: jax.Array, R: jax.Array):
    """VN phase: totals per column, hard decisions, v2c messages (column-aligned)."""
    totals = []
    for l in range(code.L):
        t = chan[:, l]
        for e in code.col_edges[l]:
            t = t + R[:, e]
        totals.append(t)
    total = jnp.stack(totals, axis=1)                    # [B, L, Z]
    hard = total < 0
    edge_l = code.edges[:, 1]
    Q = total[:, edge_l, :] - R                          # v2c, column-aligned
    return total, hard, Q


def syndrome_ok(code: QCBinaryCode, hard: jax.Array) -> jax.Array:
    """True parity check per frame: all CN parities zero. hard: [B, L, Z] bool."""
    oks = []
    for j in range(code.J):
        par = None
        for e in code.row_edges[j]:
            l, s = int(code.edges[e, 1]), int(code.edges[e, 2])
            contrib = jnp.roll(hard[:, l], -s, axis=-1)
            par = contrib if par is None else par ^ contrib
        oks.append(~jnp.any(par, axis=-1))
    return functools.reduce(jnp.logical_and, oks)


def zero_ok(code: QCBinaryCode, hard: jax.Array, message_only: bool = True) -> jax.Array:
    """The reference's check: decoded (message) bits sum to zero
    (LDPC_Decoder.cu:137-153 with Message_CW selecting msgLen vs CW_Len)."""
    ncols = code.L - code.J if message_only else code.L
    return ~jnp.any(hard[:, :ncols], axis=(1, 2))


def _check(code, hard, check: str):
    if check == "syndrome":
        return syndrome_ok(code, hard)
    if check == "zero":
        return zero_ok(code, hard)
    if check == "none":
        return jnp.zeros(hard.shape[0], dtype=bool)
    raise ValueError(f"unknown check mode {check!r}")


def _fake_int8(x: jax.Array, scale: float) -> jax.Array:
    """Simulate int8 message storage: round to the int8 grid (step 1/scale),
    clip to +-127/scale.  Used for the quantization FER study
    (VALIDATION.md): it measures what real int8 message storage would cost
    in FER before any decoder stores int8."""
    s = jnp.asarray(scale, x.dtype)
    return jnp.clip(jnp.round(x * s), -127.0, 127.0) / s


def decode_flooding(chan: jax.Array, code: QCBinaryCode, num_iters: int,
                    alpha: float = 1.0, beta: float = 0.0,
                    check: str = "syndrome", early_stop: bool = True,
                    msg_dtype=None, rule: str = "minsum",
                    int8_scale: float | None = None) -> DecodeResult:
    """Flooding BP decode. chan: [B, L, Z] channel LLRs.  ``rule='minsum'``
    (default, scale-invariant: raw AWGN output works directly, matching the
    reference which feeds raw channel samples, LDPC_Decoder.cu:203) or
    ``rule='bp'`` (exact sum-product; chan must be true LLRs 2y/sigma^2).
    ``int8_scale``: quantize c2v messages to the int8 grid with that scale
    (FER study; see _fake_int8)."""
    B = chan.shape[0]
    dtype = msg_dtype or chan.dtype
    chan = chan.astype(dtype)
    if int8_scale:                    # quantize the channel input too
        chan = _fake_int8(chan, int8_scale)
    E = code.num_edges
    cn_fn = _CN_RULES[rule]

    def one_iter(R):
        _, hard, Q = _vn_update(code, chan, R)
        newR = [None] * E
        for j in range(code.J):
            Rr = cn_fn(_row_stack(code, Q, j), alpha, beta)
            if int8_scale:
                Rr = _fake_int8(Rr, int8_scale)
            for i, e in enumerate(code.row_edges[j]):
                newR[e] = jnp.roll(Rr[:, i], int(code.edges[e, 2]), axis=-1)
        return jnp.stack(newR, axis=1), hard

    def body(state):
        it, R, _, _ = state
        R, hard = one_iter(R)
        ok = _check(code, hard, check)
        return it + 1, R, hard, ok

    def cond(state):
        it, _, _, ok = state
        not_done = ~jnp.all(ok) if early_stop else jnp.array(True)
        return jnp.logical_and(it < num_iters, not_done)

    R0 = jnp.zeros((B, E, code.Z), dtype=dtype)
    hard0 = jnp.zeros((B, code.L, code.Z), dtype=bool)
    ok0 = jnp.zeros((B,), dtype=bool)
    it, _, hard, ok = jax.lax.while_loop(cond, body, (jnp.int32(0), R0, hard0, ok0))
    return DecodeResult(hard.astype(jnp.int8), ok, it)


class BinaryCore(NamedTuple):
    """A binary decoder decomposed into jittable per-iteration pieces, the
    shape nb_decode.DecoderCore established: the carry holds ALL per-frame
    state (including the channel LLRs) so a continuous-batching driver can
    splice fresh frames into finished slots with one tree-select.

    init(chan [B, L, Z]) -> carry
    decide(carry)        -> (hard [B, L, Z] bool, totals)
    step(carry, totals, cont [B] bool) -> carry   (frozen where ~cont)
    """
    init: object
    decide: object
    step: object


def build_core(code: QCBinaryCode, rule: str = "minsum",
               schedule: str = "flooding", alpha: float = 1.0,
               beta: float = 0.0, msg_dtype=None) -> BinaryCore:
    """Per-iteration core for the jnp binary decoders (flooding or layered).
    Iteration semantics match decode_flooding / decode_layered except that
    frames are FROZEN per-frame via ``cont`` (the batch decoders instead
    keep updating converged frames until the whole batch stops, faithful to
    the reference's all-frames host loop, bldpc_实习/LDPC_Decoder.cu:94-156 —
    freezing is what a continuous-batching engine needs)."""
    cn_fn = _CN_RULES[rule]
    E = code.num_edges

    if schedule == "flooding":
        def init(chan):
            chan = chan.astype(msg_dtype or chan.dtype)
            R0 = jnp.zeros(chan.shape[:1] + (E, code.Z), dtype=chan.dtype)
            return (chan, R0)

        def decide(carry):
            chan, R = carry
            total, hard, _ = _vn_update(code, chan, R)
            return hard, total

        def step(carry, total, cont):
            chan, R = carry
            edge_l = code.edges[:, 1]
            Q = total[:, edge_l, :] - R
            newR = [None] * E
            for j in range(code.J):
                Rr = cn_fn(_row_stack(code, Q, j), alpha, beta)
                for i, e in enumerate(code.row_edges[j]):
                    newR[e] = jnp.roll(Rr[:, i], int(code.edges[e, 2]),
                                       axis=-1)
            newR = jnp.stack(newR, axis=1)
            c = cont[:, None, None]
            return (chan, jnp.where(c, newR, R))

        return BinaryCore(init, decide, step)

    if schedule == "layered":
        def init(chan):
            chan = chan.astype(msg_dtype or chan.dtype)
            R0 = jnp.zeros(chan.shape[:1] + (E, code.Z), dtype=chan.dtype)
            return (chan, R0)

        def decide(carry):
            total, _ = carry
            return total < 0, total

        def step(carry, total_unused, cont):
            total0, R0 = carry
            total = total0
            newR = list(jnp.moveaxis(R0, 1, 0))
            for j in range(code.J):
                idx = code.row_edges[j]
                shifts = [int(code.edges[e, 2]) for e in idx]
                Qr = jnp.stack(
                    [jnp.roll(total[:, int(code.edges[e, 1])] - newR[e],
                              -s, axis=-1)
                     for e, s in zip(idx, shifts)], axis=1)
                Rr = cn_fn(Qr, alpha, beta)
                for i, (e, s) in enumerate(zip(idx, shifts)):
                    new_col = jnp.roll(Rr[:, i], s, axis=-1)
                    l = int(code.edges[e, 1])
                    total = total.at[:, l].add(new_col - newR[e])
                    newR[e] = new_col
            c = cont[:, None, None]
            return (jnp.where(c, total, total0),
                    jnp.where(c, jnp.stack(newR, axis=1), R0))

        return BinaryCore(init, decide, step)

    raise ValueError(f"unknown schedule {schedule!r}")


def decode_layered(chan: jax.Array, code: QCBinaryCode, num_iters: int,
                   alpha: float = 1.0, beta: float = 0.0,
                   check: str = "syndrome", early_stop: bool = True,
                   msg_dtype=None, rule: str = "minsum") -> DecodeResult:
    """Row-layered min-sum: each block-row's CN update is applied to the running
    LLR totals immediately, converging in roughly half the iterations.  The
    binary reference only ships flooding; this is the layered schedule named in
    the BASELINE configs (and mirrors the NB layered-TMM idea,
    myNBLDPC/src/LDPC_Decoder.cpp:544-702)."""
    B = chan.shape[0]
    dtype = msg_dtype or chan.dtype
    chan = chan.astype(dtype)
    E = code.num_edges
    cn_fn = _CN_RULES[rule]

    def body(state):
        it, total, R, _, _ = state
        newR = list(jnp.moveaxis(R, 1, 0))
        for j in range(code.J):
            idx = code.row_edges[j]
            shifts = [int(code.edges[e, 2]) for e in idx]
            Qr = jnp.stack(
                [jnp.roll(total[:, int(code.edges[e, 1])] - newR[e], -s, axis=-1)
                 for e, s in zip(idx, shifts)], axis=1)
            Rr = cn_fn(Qr, alpha, beta)
            for i, (e, s) in enumerate(zip(idx, shifts)):
                new_col = jnp.roll(Rr[:, i], s, axis=-1)
                l = int(code.edges[e, 1])
                total = total.at[:, l].add(new_col - newR[e])
                newR[e] = new_col
        hard = total < 0
        ok = _check(code, hard, check)
        return it + 1, total, jnp.stack(newR, axis=1), hard, ok

    def cond(state):
        it, _, _, _, ok = state
        not_done = ~jnp.all(ok) if early_stop else jnp.array(True)
        return jnp.logical_and(it < num_iters, not_done)

    R0 = jnp.zeros((B, E, code.Z), dtype=dtype)
    hard0 = jnp.zeros((B, code.L, code.Z), dtype=bool)
    ok0 = jnp.zeros((B,), dtype=bool)
    state = (jnp.int32(0), chan, R0, hard0, ok0)
    it, _, _, hard, ok = jax.lax.while_loop(cond, body, state)
    return DecodeResult(hard.astype(jnp.int8), ok, it)
