"""Non-binary GF(q) LDPC decoders: EMS, full-EMS (log-QSPA mode), TMM, layered
TMM — pure jittable functions over dense padded graph tensors.

Numerics reproduce the CPU reference decoders (myNBLDPC/src/LDPC_Decoder.cpp):

* EMS (Decoding_EMS, :172-317): flooding Extended Min-Sum with configuration
  sets conf(q,1) + conf(Nm,Nc) and the load-bearing /1.2 output scaling (:309).
* full-EMS (decoder_method=2, Simulation.cpp:64): EMS with Nm=q, Nc=dc-1 — the
  unrestricted configuration max, here computed exactly as a forward/backward
  max-convolution over the GF(q) group instead of exponential enumeration.
* TMM (Decoding_TMM, :361-542): Trellis Min-Max in the delta domain with 1- and
  2-deviation paths and the x0.8 damping (:519).  Note the reference's flooding
  TMM *accumulates* c2v into the LLR total across iterations without resetting
  to L_ch (:431; there is no memcpy like EMS's :204) — we preserve that.
* layered TMM (Decoding_layered_TMM, :544-702): identical CN math on a serial
  row schedule with immediate LLR write-back.

Tensor reformulation (not a port): the reference sorts every edge's full
q-vector with bubble sort and recursively enumerates configuration sets
(ConstructConf, :319-359).  Here each CN works in the *delta domain*: per-edge
offset messages W[d][y] = U[d][y ^ best] - best_val (a gather along the q lane
axis; GF addition is plain XOR so index arithmetic is `arange(q) ^ shift`),
a max1/max2 reduction across edges replaces conf(q,1), and a static unroll over
slot pairs replaces conf(Nm,Nc).  No sorting, no recursion, no scatter in the
hot loop; everything is [batch, M, dc, q] tensor ops on the trailing lane axis.

Early termination runs on-device in ``lax.while_loop`` with per-frame freezing
(the reference copies decisions to the host every iteration).  Iteration
counting matches the reference: a frame whose syndrome passes at entry of pass
t reports t iterations (the reference's ``iter_number--`` on success, :236).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cuda_ldpc_tpu.models.nb_code import NBCode

NEG = -1e30   # finite -inf stand-in (avoids inf-inf NaNs under masking)
POS = 1e30
_XOR_CACHE: dict[int, np.ndarray] = {}
_HADAMARD_CACHE: dict[int, np.ndarray] = {}


def _hadamard(q: int) -> np.ndarray:
    """Walsh-Hadamard matrix H[a, b] = (-1)^popcount(a & b) (natural order).
    Self-inverse up to 1/q; diagonalizes convolution over the XOR group.
    Valid ONLY for q = 2^m (GF(2^m), where symbol addition IS bitwise XOR,
    myNBLDPC/src/GF.cpp:43); any other q would silently yield a
    non-orthogonal matrix and wrong decodes."""
    if q <= 0 or (q & (q - 1)) != 0:
        raise ValueError(f"Hadamard/QSPA requires q = 2^m, got q={q}")
    H = _HADAMARD_CACHE.get(q)
    if H is None:
        anb = np.arange(q)[:, None] & np.arange(q)[None, :]
        par = np.zeros_like(anb)
        v = anb.copy()
        while v.any():
            par ^= v & 1
            v >>= 1
        H = np.where(par == 1, -1.0, 1.0).astype(np.float32)
        _HADAMARD_CACHE[q] = H
    return H


def row_groups(cn_links: np.ndarray, cn_mask: np.ndarray) -> list[np.ndarray]:
    """Partition CN rows into conflict-free groups (no two rows in a group
    share a variable node) by greedy coloring, preserving ascending row order
    inside each group.  Rows in one group can run a layered update
    concurrently without read/write interference, turning the serial
    M-row layered sweep into ~(max VN degree x dc) well-vectorized group
    updates — for QC-lifted codes this recovers the block-row structure
    (e.g. the 1152-row Tanner_74_9_Z128_GF16 colors into its 9 block rows)."""
    M = cn_links.shape[0]
    vn_rows: dict[int, list[int]] = {}
    row_vns = []
    for m in range(M):
        vns = [int(v) for v, ok in zip(cn_links[m], cn_mask[m]) if ok]
        row_vns.append(vns)
        for v in vns:
            vn_rows.setdefault(v, []).append(m)
    color = np.full(M, -1, dtype=np.int64)
    for m in range(M):
        used = {int(color[r]) for v in row_vns[m] for r in vn_rows[v]
                if color[r] >= 0}
        c = 0
        while c in used:
            c += 1
        color[m] = c
    return [np.flatnonzero(color == c) for c in range(int(color.max()) + 1)]


class NBDecodeResult(NamedTuple):
    hard: jax.Array    # [B, N] int32 hard symbol decisions
    ok: jax.Array      # [B] bool — GF syndrome == 0
    iters: jax.Array   # [B] int32 — iterations used (reference counting)


class _Graph(NamedTuple):
    """Static numpy graph tensors (jit constants)."""
    q: int
    N: int
    M: int
    dv: int
    dc: int
    vn_gather: np.ndarray   # [N, dv] flat index into the [M*dc] CN-edge axis
    vn_mask: np.ndarray     # [N, dv] bool
    cn_links: np.ndarray    # [M, dc] VN index
    cn_mask: np.ndarray     # [M, dc] bool
    h_perm: np.ndarray      # [M, dc, q]: k -> h*k  (all-0 rows on masked edges)
    xor_table: np.ndarray   # [q, q]
    h_onehot: np.ndarray    # [M, dc, q, q]: P[k, v] = (v == h*k), uint8


def build_graph(code: NBCode) -> _Graph:
    mul = code.mul_table
    inv = code.inv_table
    h = code.cn_gf                              # [M, dc]
    vn_gather = code.vn_links * code.max_dc + code.vn_slot
    h_perm = mul[h].astype(np.int32)
    h_onehot = np.eye(code.q, dtype=np.uint8)[h_perm]   # [M, dc, q(k), q(v)]
    return _Graph(q=code.q, N=code.n_sym, M=code.m_sym, dv=code.max_dv,
                  dc=code.max_dc, vn_gather=vn_gather, vn_mask=code.vn_mask,
                  cn_links=code.cn_links, cn_mask=code.cn_mask,
                  h_perm=h_perm,
                  xor_table=code.xor_table.astype(np.int32),
                  h_onehot=h_onehot)


# --------------------------------------------------------------------------
# shared phases
# --------------------------------------------------------------------------

def _gather_c2v_vn(g: _Graph, c2v_cn: jax.Array) -> jax.Array:
    """CN-aligned c2v [B, M, dc, q] -> VN-aligned [B, N, dv, q] (masked)."""
    B = c2v_cn.shape[0]
    flat = c2v_cn.reshape(B, g.M * g.dc, g.q)
    out = flat[:, g.vn_gather]                  # [B, N, dv, q]
    return jnp.where(jnp.asarray(g.vn_mask)[None, :, :, None], out, 0.0)


def _syndrome_ok(g: _Graph, hard: jax.Array) -> jax.Array:
    """True GF syndrome check per frame: all rows have sum h_i * x_i == 0
    (myNBLDPC/src/LDPC_Decoder.cpp:218-238).  hard: [B, N] int32.

    The per-edge table lookup h_perm[m, d, hard] is a one-hot masked
    reduction rather than take_along_axis (a gather along the q axis); which
    of the two is faster on the GPU is not measured yet (ROADMAP S4)."""
    hard_cn = hard[:, g.cn_links]               # [B, M, dc] (static gather)
    perm = jnp.asarray(g.h_perm)                # [M, dc, q]; masked rows all 0
    oh = hard_cn[..., None] == jnp.arange(g.q, dtype=hard_cn.dtype)
    contrib = jnp.sum(jnp.where(oh, perm[None], 0), axis=-1)   # [B, M, dc]
    syn = contrib[:, :, 0]
    for d in range(1, g.dc):
        syn = jnp.bitwise_xor(syn, contrib[:, :, d])
    return jnp.all(syn == 0, axis=1)


def _perm_fwd(x, h_onehot):
    """y[k] = x[h*k] as a one-hot contraction (a [q, q] one-hot matmul in
    place of a gather along q; ROADMAP S4 weighs the two on the GPU).
    x: [B, M', dc, q(v)]; h_onehot: [M', dc, q(k), q(v)] -> [B, M', dc, q(k)].

    precision=HIGHEST makes the permutation EXACT: one 1.0 times a full f32
    keeps all 24 mantissa bits.  A reduced-precision product (TF32 on the
    GPU, bf16 elsewhere) rounds the permuted values, which cascades through
    the max-domain decoders' argmax->xor-shift chains."""
    return jnp.einsum("bmdv,mdkv->bmdk", x, h_onehot,
                      preferred_element_type=x.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def _perm_inv(x, h_onehot):
    """y[v] = x[h^-1 v]  (same one-hot tensor, transposed contraction).
    x: [B, M', dc, q(s)] -> [B, M', dc, q(v)] with y[v] = x[s] where v=h*s.
    precision=HIGHEST: see _perm_fwd."""
    return jnp.einsum("bmds,mdsv->bmdv", x, h_onehot,
                      preferred_element_type=x.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def _xor_shift_const(x: jax.Array, j: int) -> jax.Array:
    """x[..., y] -> x[..., y ^ j] for a COMPILE-TIME constant j: pure static
    block swaps (reshape + flip per set bit), no selects, no gathers."""
    q = x.shape[-1]
    for b in range(q.bit_length() - 1):
        if (j >> b) & 1:
            stride = 1 << b
            xr = x.reshape(x.shape[:-1] + (q // (2 * stride), 2, stride))
            x = jnp.flip(xr, axis=-2).reshape(x.shape)
    return x


def _xor_shift(x: jax.Array, s: jax.Array) -> jax.Array:
    """x[..., y] -> x[..., y ^ s] along the trailing q axis (GF add == XOR).

    Implemented as log2(q) conditional block-swaps instead of a gather: XOR
    with bit b of s swaps adjacent index blocks of size 2^b, so each bit is a
    static flip selected per element by that bit of s.  All vector selects —
    no serial gather in the hot loop."""
    q = x.shape[-1]
    nbits = q.bit_length() - 1
    for b in range(nbits):
        stride = 1 << b
        xr = x.reshape(x.shape[:-1] + (q // (2 * stride), 2, stride))
        swapped = jnp.flip(xr, axis=-2).reshape(x.shape)
        bit = ((s >> b) & 1).astype(bool)[..., None]
        x = jnp.where(bit, swapped, x)
    return x


# --------------------------------------------------------------------------
# EMS check-node core (conf(q,1) + conf(Nm,Nc)) in the delta domain
# --------------------------------------------------------------------------

def _ems_cn_core(v2c_cn, mask, h_onehot, nm: int, nc: int, dc: int,
                 q: int):
    """One EMS CN update.  v2c_cn: [B, M', dc, q] VN-symbol-domain messages
    (L[0]=0 convention); mask [M', dc] bool; h_onehot [M', dc, q, q].
    Returns new c2v, same shape/domain, already /1.2.

    Equivalence to the reference's ConstructConf enumeration (LDPC_Decoder.cpp:
    272-311, 319-359): every configuration's LLR is sum0 + (deviation deltas)
    and its GF value is g0 ^ (deviation offsets), where sum0/g0 are the
    all-best-slot baseline excluding the output edge.  The baseline terms
    cancel in the normalized output (EMS_L_c2v[v] - EMS_L_c2v[0]), so only the
    delta profile D[y] = best config value at offset y is needed:
      conf(q,1)  -> per-edge delta message W[d][y], max1/max2 across edges
                    (exclude-own-edge via the argmax column trick),
      conf(Nm,2) -> static unroll over edge pairs at their top-(Nm-1)
                    non-best slots,
      conf(Nm,Nc>2) -> budgeted forward/backward (max,+) convolution DP
                    over the XOR group (general Nc; Nc >= dc-1 drops the
                    budget axis — the reference's maxdc-1 sentinel,
                    Simulation.cpp:296-299).
    Output: c2v[k] = (D[h*k ^ g0] - D[g0]) / 1.2 with g0 the baseline GF value
    excluding the output edge."""
    maskq = mask[None, :, :, None]
    U = jnp.where(maskq, _perm_inv(v2c_cn, h_onehot), NEG)  # [B, M', dc, q]
    c0 = jnp.argmax(U, axis=-1).astype(jnp.int32)        # [B, M', dc]
    v0 = jnp.max(U, axis=-1)
    W = _xor_shift(U, c0) - v0[..., None]
    W = jnp.where(maskq, W, NEG)

    # conf(q,1): best / second-best single deviation across edges, per offset y
    m1 = jnp.max(W, axis=2)                              # [B, M', q]
    am = jnp.argmax(W, axis=2)
    excl = jax.nn.one_hot(am, dc, axis=2, dtype=bool)    # [B, M', dc, q]
    m2 = jnp.max(jnp.where(excl, NEG, W), axis=2)
    douts = jnp.arange(dc, dtype=am.dtype)[None, None, :, None]
    D = jnp.where(am[:, :, None, :] == douts, m2[:, :, None, :],
                  m1[:, :, None, :])                     # [B, M', dc_out, q]

    if nc >= 2 and nm >= 2 and dc >= 3:
        # top-(Nm-1) non-best slots per edge (the conf(Nm, .) alphabet)
        W0 = jnp.where(jnp.arange(q) == 0, NEG, W)       # forbid the 0 offset
        if nm - 1 == 1:
            P = jnp.max(W0, axis=-1, keepdims=True)      # [B, M', dc, 1]
            O = jnp.argmax(W0, axis=-1, keepdims=True).astype(jnp.int32)
        else:
            P, O = jax.lax.top_k(W0, nm - 1)
            O = O.astype(jnp.int32)
        yy = jnp.arange(q, dtype=jnp.int32)
        if nc == 2:
            # conf(Nm, 2): static unroll over edge pairs
            for a in range(dc):
                for b in range(a + 1, dc):
                    ok_out = np.array([d != a and d != b for d in range(dc)])
                    sel = jnp.asarray(ok_out)[None, None, :, None]
                    for ka in range(nm - 1):
                        for kb in range(nm - 1):
                            val = P[:, :, a, ka] + P[:, :, b, kb]   # [B, M']
                            off = jnp.bitwise_xor(O[:, :, a, ka],
                                                  O[:, :, b, kb])
                            upd = jnp.where(off[..., None] == yy,
                                            val[..., None],
                                            NEG)[:, :, None, :]  # [B, M', 1, q]
                            D = jnp.where(sel, jnp.maximum(D, upd), D)
        else:
            # conf(Nm, Nc), general Nc: up to Nc edges deviate, each within
            # its top-(Nm-1) non-best slots — the reference's recursive
            # ConstructConf with an arbitrary EMS_NC (LDPC_Decoder.cpp:
            # 319-359; EMS_Nc == maxdc-1 is the 'all edges may deviate'
            # sentinel, Simulation.cpp:296-299).  Fixed-shape re-derivation:
            # per-edge clipped delta message dev[y] (top-(Nm-1) deltas at
            # their XOR offsets, NEG elsewhere), combined by exclusive
            # forward/backward (max,+) convolution chains over the XOR group.
            dev = jnp.full(W.shape, NEG)
            for k in range(nm - 1):
                dev = jnp.maximum(dev, jnp.where(
                    O[..., k, None] == yy, P[..., k, None], NEG))
            ident = jnp.where(jnp.arange(q) == 0, 0.0, NEG)
            xt = jnp.asarray(_XOR_CACHE.setdefault(
                q, (np.arange(q)[:, None] ^ np.arange(q)[None, :])
                .astype(np.int32)))
            ident_b = jnp.broadcast_to(ident, dev[:, :, 0].shape)
            if nc >= dc - 1:
                # unbudgeted: every edge freely deviates or not
                msg = jnp.maximum(dev, ident)
                msg = jnp.where(maskq, msg, ident)
                fwd = [ident_b]
                for d in range(dc - 1):
                    fwd.append(_maxconv(fwd[-1], msg[:, :, d], xt))
                bwd = [ident_b]
                for d in range(dc - 1, 0, -1):
                    bwd.append(_maxconv(bwd[-1], msg[:, :, d], xt))
                bwd = bwd[::-1]
                D2 = jnp.stack([_maxconv(fwd[d], bwd[d], xt)
                                for d in range(dc)], axis=2)
            else:
                # budgeted DP over (deviation count <= c, XOR offset y):
                #   F_d[c] = max(F_{d-1}[c], maxconv(F_{d-1}[c-1], dev_d))
                # (cumulative-in-c states compose because (max,+) convolution
                # distributes over max), then the exclusive-of-edge-d profile
                # is max_{c} maxconv(fwd_d[c], bwd_d[nc-c]).
                devm = jnp.where(maskq, dev, NEG)   # padded edges never deviate

                def extend(states, d):
                    new = [states[0]]
                    for c in range(1, nc + 1):
                        new.append(jnp.maximum(
                            states[c],
                            _maxconv(states[c - 1], devm[:, :, d], xt)))
                    return new

                # state[c] = best value using AT MOST c deviations, so every
                # budget level starts from the empty config (ident)
                fwd = [[ident_b] * (nc + 1)]
                for d in range(dc - 1):
                    fwd.append(extend(fwd[-1], d))
                bwd = [[ident_b] * (nc + 1)]
                for d in range(dc - 1, 0, -1):
                    bwd.append(extend(bwd[-1], d))
                bwd = bwd[::-1]
                D2 = jnp.stack([
                    functools.reduce(jnp.maximum, [
                        _maxconv(fwd[d][c], bwd[d][nc - c], xt)
                        for c in range(nc + 1)])
                    for d in range(dc)], axis=2)
            D = jnp.maximum(D, D2)
    elif nc < 1:
        raise ValueError(f"EMS needs Nc >= 1, got Nc={nc}")

    # baseline GF value excluding the output edge: g0 = (xor of all c0) ^ c0[dout]
    c0m = jnp.where(mask[None], c0, 0)
    call = c0m[:, :, 0]
    for d in range(1, dc):
        call = jnp.bitwise_xor(call, c0m[:, :, d])
    g0 = jnp.bitwise_xor(call[:, :, None], c0m)          # [B, M', dc]

    D_shift = _xor_shift(D, g0)                  # D_shift[y] = D[y ^ g0]
    Dg = _perm_fwd(D_shift, h_onehot)            # Dg[k] = D[h*k ^ g0]
    D0 = D_shift[..., 0:1]                       # D[g0]
    c2v = (Dg - D0) * (1.0 / 1.2)
    return jnp.where(maskq, c2v, 0.0)


def _maxconv(A: jax.Array, Bm: jax.Array, xor_table: jax.Array) -> jax.Array:
    """(max,+) convolution over the XOR group: out[x] = max_u A[u] + B[u^x]."""
    Bg = jnp.take(Bm, xor_table, axis=-1)                # [..., u, x] = B[u^x]
    return jnp.max(A[..., :, None] + Bg, axis=-2)


def _ems_full_cn_core(v2c_cn, mask, h_onehot, xor_table, dc: int, q: int):
    """Full-configuration EMS (the reference's decoder_method=2: Nm=q,
    Nc=dc-1, Simulation.cpp:64) via exclusive forward/backward max-convolution
    products — mathematically identical to the unrestricted ConstructConf
    enumeration, polynomial instead of exponential."""
    maskq = mask[None, :, :, None]
    ident = jnp.where(jnp.arange(q) == 0, 0.0, NEG)      # max-conv identity
    U = jnp.where(maskq, _perm_inv(v2c_cn, h_onehot), ident)
    fwd = [jnp.broadcast_to(ident, U[:, :, 0].shape)]
    for d in range(dc - 1):
        fwd.append(_maxconv(fwd[-1], U[:, :, d], xor_table))
    bwd = [jnp.broadcast_to(ident, U[:, :, 0].shape)]
    for d in range(dc - 1, 0, -1):
        bwd.append(_maxconv(bwd[-1], U[:, :, d], xor_table))
    bwd = bwd[::-1]
    excl = jnp.stack([_maxconv(fwd[d], bwd[d], xor_table) for d in range(dc)],
                     axis=2)                             # [B, M', dc, q]
    Eg = _perm_fwd(excl, h_onehot)
    c2v = (Eg - excl[..., 0:1]) * (1.0 / 1.2)
    return jnp.where(maskq, c2v, 0.0)


def _qspa_cn_core(v2c_cn, mask, h_onehot, had, dc: int, q: int,
                  eps: float = 1e-30):
    """True probability-domain sum-product (FFT-QSPA) CN update.

    The check constraint sum_d h_d x_d = 0 makes each c2v message the XOR-group
    convolution of the other edges' pmfs of y_d = h_d x_d; the Walsh-Hadamard
    transform diagonalizes that convolution, so the whole update is two [q, q]
    Hadamard matmuls around an exclusive product across edges.  This is
    the exact decoder the reference's decoder_method=2 approximates in the
    max-sum domain (myNBLDPC/src/Simulation.cpp:64 runs EMS with Nm=q,
    Nc=dc-1) — the BASELINE.json 'FFT-QSPA decode' config; no counterpart
    exists in the reference source.

    v2c_cn: [B, M', dc, q] LLR-domain messages over VN symbols (L[0] = 0).
    Returns c2v in the same domain/shape."""
    maskq = mask[None, :, :, None]
    U = _perm_inv(v2c_cn, h_onehot)              # LLRs over y = h*x
    p = jax.nn.softmax(jnp.where(maskq, U, NEG), axis=-1)
    # padded edges carry the delta-at-0 pmf = the convolution identity
    ident = jnp.where(jnp.arange(q) == 0, 1.0, 0.0)
    p = jnp.where(maskq, p, ident)
    # precision=HIGHEST is load-bearing: a reduced-precision product (TF32
    # on the GPU, bf16 elsewhere) destroys the Hadamard transform's
    # cancellation (spectra sit near 1 and the inverse transform differences
    # are ~1e-4..1e-6); with bf16 products FER was 6.6e-2 vs 0/512 at 2 dB
    # on the GF(64) code
    hi = jax.lax.Precision.HIGHEST
    F = jnp.einsum("bmdq,qk->bmdk", p, had,
                   preferred_element_type=jnp.float32, precision=hi)
    one = jnp.ones_like(F[:, :, 0])
    fwd = [one]
    for d in range(dc - 1):
        fwd.append(fwd[-1] * F[:, :, d])
    bwd = [one]
    for d in range(dc - 1, 0, -1):
        bwd.append(bwd[-1] * F[:, :, d])
    bwd = bwd[::-1]
    excl = jnp.stack([fwd[d] * bwd[d] for d in range(dc)], axis=2)
    pout = jnp.einsum("bmdk,kq->bmdq", excl, had,
                      preferred_element_type=jnp.float32, precision=hi) / q
    # tiny negatives can appear from float cancellation; clip before the log
    llr = jnp.log(jnp.maximum(pout, eps))
    out = _perm_fwd(llr, h_onehot)               # back to VN symbol domain
    out = out - out[..., 0:1]
    return jnp.where(maskq, out, 0.0)


# --------------------------------------------------------------------------
# TMM check-node core (min domain)
# --------------------------------------------------------------------------

def _tmm_cn_core(v2c_cn, mask, h_perm, h_onehot, dc: int, q: int):
    """One TMM CN update on min-domain messages [B, M', dc, q] (VN symbol
    domain).  Mirrors d_TMM_Get_Zn / Get_deltaU / Get_Min / ConstructConf and
    the I/E path-select output with x0.8 damping
    (myNBLDPC/src/LDPC_Decoder.cpp:488-521, 704-817)."""
    maskq = mask[None, :, :, None]
    maskd = mask[None]
    v2c = jnp.where(maskq, v2c_cn, POS)
    # Zn: per-edge argmin in VN-domain scan order (ties -> lowest symbol, like
    # the reference's strict-< scan, :711-718), mapped through h to CN domain
    qmin = jnp.argmin(v2c, axis=-1).astype(jnp.int32)    # [B, M', dc]
    vmin = jnp.min(v2c, axis=-1)
    # h_perm[m, d, qmin] as a one-hot masked reduction (see _syndrome_ok)
    oh = qmin[..., None] == jnp.arange(q, dtype=qmin.dtype)
    Zn = jnp.sum(jnp.where(oh, h_perm[None], 0), axis=-1)
    Zn = jnp.where(maskd, Zn, 0)
    syn = Zn[:, :, 0]
    for d in range(1, dc):
        syn = jnp.bitwise_xor(syn, Zn[:, :, d])          # [B, M']

    # delta domain: dU[d][eta] = U[eta ^ Zn[d]] - min   (:725-743)
    U = jnp.where(maskq, _perm_inv(v2c_cn, h_onehot), POS)
    dU = _xor_shift(U, Zn) - vmin[..., None]
    dU = jnp.where(maskq, dU, POS)

    # per-eta min1/min2 and min1 column across edges (:745-770)
    min1 = jnp.min(dU, axis=2)                           # [B, M', q]
    col = jnp.argmin(dU, axis=2).astype(jnp.int32)
    excl = jax.nn.one_hot(col, dc, axis=2, dtype=bool)
    min2 = jnp.min(jnp.where(excl, POS, dU), axis=2)

    # 2-deviation search over (j, k=i^j): cand = max(min1[j], min1[k]), valid
    # when the two min columns differ and the values differ (the reference's
    # strict-inequality branches skip exact ties, :793-811).
    #
    # An unrolled running min over j with CONSTANT xor shifts: the one-shot
    # formulation materializes [B, M', q, q] candidate tensors in device
    # memory every iteration plus q-lane gathers; here every intermediate is
    # [B, M', q] and XLA fuses the whole scan.  Results are bit-identical: same candidate values, and the
    # strict `cand < I2` update keeps the FIRST minimizing j exactly like
    # jnp.argmin's first-tie rule.
    lane = jnp.arange(q, dtype=jnp.int32)
    I2 = jnp.full(min1.shape, POS)
    p1_2 = jnp.zeros_like(col)
    p2_2 = jnp.zeros_like(col)
    for j in range(q):
        vj = min1[..., j:j + 1]                          # [B, M', 1]
        cjv = col[..., j:j + 1]
        mk = _xor_shift_const(min1, j)                   # min1[i ^ j]
        ckv = _xor_shift_const(col, j)
        valid = (cjv != ckv) & (vj != mk) & (lane != j)
        cand = jnp.where(valid, jnp.maximum(vj, mk), POS)
        better = cand < I2
        I2 = jnp.where(better, cand, I2)
        p1_2 = jnp.where(better, jnp.broadcast_to(cjv, col.shape), p1_2)
        p2_2 = jnp.where(better, ckv, p2_2)

    use2 = I2 < min1
    I = jnp.where(use2, I2, min1)
    E = jnp.where(use2, min1, min2)
    p1 = jnp.where(use2, p1_2, col)
    p2 = jnp.where(use2, p2_2, col)

    # output: Lc2p[eta] = E if dout on the path else I; eta=0 forced to 0;
    # c2v[dout][v] = 0.8 * Lc2p[h*v ^ syn ^ Zn[dout]]   (:496-521)
    douts = jnp.arange(dc, dtype=jnp.int32)[None, None, :, None]
    on_path = (douts == p1[:, :, None, :]) | (douts == p2[:, :, None, :])
    Lc2p = jnp.where(on_path, E[:, :, None, :], I[:, :, None, :])
    Lc2p = jnp.where(jnp.arange(q) == 0, 0.0, Lc2p)      # [B, M', dc, q(eta)]
    beta_syn = jnp.bitwise_xor(syn[:, :, None], Zn)      # [B, M', dc]
    # c2v[v] = Lc2p[h*v ^ beta_syn]: xor-shift then static h permutation
    c2v = 0.8 * _perm_fwd(_xor_shift(Lc2p, beta_syn), h_onehot)
    return jnp.where(maskq, c2v, 0.0)


# --------------------------------------------------------------------------
# decoders
# --------------------------------------------------------------------------

def _freeze(active, new, old):
    """Per-frame select along the batch axis (active: [B])."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return jnp.where(a, new, old)


class DecoderCore(NamedTuple):
    """A decoder decomposed into jittable per-iteration pieces so the batch
    driver (_run) and the streaming continuous-batching driver (sim.py) can
    share one implementation.  The carry is a pytree holding ALL per-frame
    decoder state (including the channel LLRs), so a streaming driver can
    splice fresh frames into finished batch slots with one tree-select."""
    g: _Graph
    init: object      # L_ch [B, N, q] -> carry
    decide: object    # carry -> (hard [B, N] int32, llr)
    step: object      # (carry, llr, cont [B] bool) -> carry


def build_core(code: NBCode, method: str, nm: int = 2,
               nc: int = 2) -> DecoderCore:
    """Decoder core for ``method`` ('ems' | 'ems_full' | 'qspa' |
    'layered_qspa' | 'tmm' | 'layered_tmm') — see make_decoder for the
    mapping to the reference's decoder_method values."""
    g = build_graph(code)
    mask = jnp.asarray(g.cn_mask)
    h_perm = jnp.asarray(g.h_perm)
    h_onehot = jnp.asarray(g.h_onehot, dtype=jnp.float32)
    xor_table = jnp.asarray(g.xor_table)
    cn_links_j = jnp.asarray(g.cn_links)

    if method in ("ems", "ems_full", "qspa"):
        had = jnp.asarray(_hadamard(g.q)) if method == "qspa" else None

        def init(L_ch):
            L = L_ch.astype(jnp.float32)
            c2v0 = jnp.zeros(L.shape[:1] + (g.M, g.dc, g.q), jnp.float32)
            return (L, c2v0)

        def decide(carry):
            L, c2v = carry
            llr = L + jnp.sum(_gather_c2v_vn(g, c2v), axis=2)
            # argmax with 0 fallback == plain argmax, since L[0] = 0 exactly
            # (DecideLLRVector, LDPC_Decoder.cpp:71-91)
            return jnp.argmax(llr, axis=-1).astype(jnp.int32), llr

        def step(carry, llr, cont):
            L, c2v = carry
            v2c = llr[:, g.cn_links] - c2v
            if method == "qspa":
                new = _qspa_cn_core(v2c, mask, h_onehot, had, g.dc, g.q)
            elif method == "ems_full":
                new = _ems_full_cn_core(v2c, mask, h_onehot, xor_table,
                                        g.dc, g.q)
            else:
                new = _ems_cn_core(v2c, mask, h_onehot, nm, nc, g.dc, g.q)
            return (L, _freeze(cont, new, c2v))

        return DecoderCore(g, init, decide, step)

    if method == "tmm":
        def init(L_ch):
            Lmin = to_min_domain(L_ch.astype(jnp.float32))
            c2v0 = jnp.zeros(Lmin.shape[:1] + (g.M, g.dc, g.q), jnp.float32)
            return (Lmin, c2v0)

        def decide(carry):
            llr_state, c2v = carry
            llr = llr_state + jnp.sum(_gather_c2v_vn(g, c2v), axis=2)
            return jnp.argmin(llr, axis=-1).astype(jnp.int32), llr

        def step(carry, llr, cont):
            llr_state, c2v = carry
            v2c = llr[:, g.cn_links] - c2v
            new = _tmm_cn_core(v2c, mask, h_perm, h_onehot, g.dc, g.q)
            return (_freeze(cont, llr, llr_state), _freeze(cont, new, c2v))

        return DecoderCore(g, init, decide, step)

    if method in ("glayered_tmm", "glayered_qspa"):
        # Grouped-layered schedule: greedy-colored conflict-free row groups
        # sweep in sequence; rows inside a group update concurrently (they
        # share no VN).  Fresh information still propagates between groups
        # within one sweep, so convergence tracks the serial layered
        # schedule, but the sweep is ~len(groups) vectorized updates instead
        # of M serial ones.  No reference counterpart
        # (the reference's layered TMM is strictly serial,
        # myNBLDPC/src/LDPC_Decoder.cpp:544-702).
        tmm = method == "glayered_tmm"
        had = None if tmm else jnp.asarray(_hadamard(g.q))
        groups = row_groups(g.cn_links, g.cn_mask)

        def init(L_ch):
            L = L_ch.astype(jnp.float32)
            llr0 = to_min_domain(L) if tmm else L
            c2v0 = jnp.zeros(L.shape[:1] + (g.M, g.dc, g.q), jnp.float32)
            return (llr0, c2v0)

        def decide(carry):
            llr, _ = carry
            pick = jnp.argmin if tmm else jnp.argmax
            return pick(llr, axis=-1).astype(jnp.int32), llr

        def step(carry, llr_unused, cont):
            llr0, c2v0 = carry
            llr, c2v = llr0, c2v0
            for rows in groups:
                links = g.cn_links[rows]                   # [G, dc] static
                rmask = jnp.asarray(g.cn_mask[rows])
                roh = jnp.asarray(g.h_onehot[rows], dtype=jnp.float32)
                llr_rows = llr[:, links]                   # [B, G, dc, q]
                v2c = llr_rows - c2v[:, rows]
                mm = rmask[None, :, :, None]
                if tmm:
                    rh = jnp.asarray(g.h_perm[rows])
                    new = _tmm_cn_core(v2c, rmask, rh, roh, g.dc, g.q)
                    delta = jnp.where(mm, v2c + new - llr_rows, 0.0)
                else:
                    new = _qspa_cn_core(v2c, rmask, roh, had, g.dc, g.q)
                    delta = jnp.where(mm, new - c2v[:, rows], 0.0)
                # scatter-add: VNs are disjoint within a group by
                # construction; padded edges (links -> VN 0) carry delta 0,
                # so their duplicate indices stay well-defined
                llr = llr.at[:, links].add(delta)
                c2v = c2v.at[:, rows].set(new)
            return (_freeze(cont, llr, llr0), _freeze(cont, c2v, c2v0))

        return DecoderCore(g, init, decide, step)

    if method in ("layered_tmm", "layered_qspa"):
        tmm = method == "layered_tmm"
        mask_j = mask
        h_onehot_j = h_onehot
        had = None if tmm else jnp.asarray(_hadamard(g.q))

        def init(L_ch):
            L = L_ch.astype(jnp.float32)
            llr0 = to_min_domain(L) if tmm else L
            c2v0 = jnp.zeros(L.shape[:1] + (g.M, g.dc, g.q), jnp.float32)
            return (llr0, c2v0)

        def decide(carry):
            llr, _ = carry
            pick = jnp.argmin if tmm else jnp.argmax
            return pick(llr, axis=-1).astype(jnp.int32), llr

        def step(carry, llr_unused, cont):
            llr0, c2v0 = carry

            def row_body(m, lc):
                llr, c2v = lc
                links = jax.lax.dynamic_index_in_dim(cn_links_j, m,
                                                     keepdims=False)
                rmask = jax.lax.dynamic_index_in_dim(mask_j, m)      # [1, dc]
                roh = jax.lax.dynamic_index_in_dim(h_onehot_j, m)
                llr_row = llr[:, links]                              # [B, dc, q]
                v2c = llr_row - c2v[:, m]
                if tmm:
                    rh = jax.lax.dynamic_index_in_dim(h_perm, m)     # [1, dc, q]
                    new = _tmm_cn_core(v2c[:, None], rmask, rh, roh,
                                       g.dc, g.q)[:, 0]
                    # scatter-add a masked delta: pad edges (links pointing
                    # at VN 0) contribute 0, so duplicates stay well-defined
                    delta = jnp.where(rmask[0][None, :, None],
                                      v2c + new - llr_row, 0.0)
                else:
                    new = _qspa_cn_core(v2c[:, None], rmask, roh, had,
                                        g.dc, g.q)[:, 0]
                    # write back total = v2c + new, i.e. add (new - old c2v)
                    delta = jnp.where(rmask[0][None, :, None],
                                      new - c2v[:, m], 0.0)
                llr = llr.at[:, links].add(delta)
                c2v = jax.lax.dynamic_update_index_in_dim(c2v, new, m, axis=1)
                return llr, c2v

            llr1, c2v1 = jax.lax.fori_loop(0, g.M, row_body, (llr0, c2v0))
            return (_freeze(cont, llr1, llr0), _freeze(cont, c2v1, c2v0))

        return DecoderCore(g, init, decide, step)

    raise ValueError(f"unknown NB decoder method {method!r}")


def _run(g: _Graph, B: int, max_iters: int, early_stop: bool, carry0,
         step_fn, decide_fn):
    """While-loop driver with the reference's iteration accounting: each pass
    decides from the current state, checks the syndrome, then (for frames
    still active) runs one CN-update phase."""

    def body(state):
        t, carry, hard, ok, iters = state
        hard_new, llr = decide_fn(carry)
        ok_new = _syndrome_ok(g, hard_new)
        active = ~ok
        hard = _freeze(active, hard_new, hard)
        ok2 = jnp.where(active, ok_new, ok)
        iters = jnp.where(active & ok_new, t,
                          jnp.where(active, t + 1, iters))
        cont = active & ~ok_new
        carry = step_fn(carry, llr, cont)
        return t + 1, carry, hard, ok2, iters

    def cond(state):
        t, _, _, ok, _ = state
        not_done = ~jnp.all(ok) if early_stop else jnp.array(True)
        return jnp.logical_and(t < max_iters, not_done)

    hard0 = jnp.zeros((B, g.N), dtype=jnp.int32)
    ok0 = jnp.zeros((B,), dtype=bool)
    it0 = jnp.zeros((B,), dtype=jnp.int32)
    state = (jnp.int32(0), carry0, hard0, ok0, it0)
    _, _, hard, ok, iters = jax.lax.while_loop(cond, body, state)
    return NBDecodeResult(hard, ok, iters)


def decode_ems(L_ch: jax.Array, code: NBCode, max_iters: int, nm: int = 2,
               nc: int = 2, full: bool = False,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding EMS decode.  L_ch: [B, N, q] symbol LLRs (log P(s)/P(0),
    L[...,0]=0).  ``full=True`` is the reference's decoder_method=2."""
    core = build_core(code, "ems_full" if full else "ems", nm=nm, nc=nc)
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


def decode_qspa(L_ch: jax.Array, code: NBCode, max_iters: int,
                early_stop: bool = True) -> NBDecodeResult:
    """Flooding FFT-QSPA (exact sum-product via Walsh-Hadamard CN
    convolution).  L_ch: [B, N, q] symbol LLRs (log P(s)/P(0), L[...,0]=0).
    Same flooding schedule / syndrome early-exit / iteration accounting as
    EMS; only the CN core differs (see _qspa_cn_core)."""
    core = build_core(code, "qspa")
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


def to_min_domain(L_ch: jax.Array) -> jax.Array:
    """Positive-LLR domain -> TMM min domain: m - L with m = max over nonzero
    symbols only (Decoding_TMM init, LDPC_Decoder.cpp:364-390; symbol 0 gets
    value m, possibly negative, exactly like the reference)."""
    m = jnp.max(L_ch[..., 1:], axis=-1, keepdims=True)
    return m - L_ch


def decode_tmm(L_ch: jax.Array, code: NBCode, max_iters: int,
               early_stop: bool = True) -> NBDecodeResult:
    """Flooding TMM decode.  L_ch: [B, N, q] positive-domain symbol LLRs
    (converted internally).  Preserves the reference's accumulating LLR total
    (no reset to L_ch between iterations, LDPC_Decoder.cpp:425-435)."""
    core = build_core(code, "tmm")
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


def decode_layered_tmm(L_ch: jax.Array, code: NBCode, max_iters: int,
                       early_stop: bool = True) -> NBDecodeResult:
    """Row-layered TMM: serial sweep over CN rows, each row's update written
    back to the LLR total immediately (Decoding_layered_TMM,
    LDPC_Decoder.cpp:544-702).  The decision+syndrome run at the top of each
    sweep from the current totals, before any row of that sweep (:603-605)."""
    core = build_core(code, "layered_tmm")
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


def decode_layered_qspa(L_ch: jax.Array, code: NBCode, max_iters: int,
                        early_stop: bool = True) -> NBDecodeResult:
    """Row-layered FFT-QSPA: serial sweep over CN rows with each row's exact
    sum-product update written back to the LLR totals immediately — the
    layered schedule the reference ships only for TMM
    (Decoding_layered_TMM, myNBLDPC/src/LDPC_Decoder.cpp:544-702) applied to
    the optimal CN rule (no reference counterpart).  Converges in roughly
    half the flooding-QSPA iterations.  L_ch: [B, N, q] symbol LLRs
    (log P(s)/P(0), L[...,0]=0)."""
    core = build_core(code, "layered_qspa")
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


METHODS = ("ems", "ems_full", "qspa", "layered_qspa", "glayered_qspa",
           "tmm", "layered_tmm", "glayered_tmm")


def decode(L_ch: jax.Array, code: NBCode, method: str, max_iters: int,
           nm: int = 2, nc: int = 2,
           early_stop: bool = True) -> NBDecodeResult:
    """Generic NB decode: any method from METHODS on [B, N, q] symbol LLRs
    (TMM variants convert to the min domain internally)."""
    core = build_core(code, method, nm=nm, nc=nc)
    return _run(core.g, L_ch.shape[0], max_iters, early_stop,
                core.init(L_ch), core.step, core.decide)


def make_decoder(code: NBCode, method: str = "ems", max_iters: int = 20,
                 nm: int = 2, nc: int = 2, early_stop: bool = True):
    """Build a jitted ``decode(L_ch) -> NBDecodeResult`` for a code.

    ``method``: 'ems' | 'ems_full' | 'tmm' | 'layered_tmm' — the reference's
    decoder_method 0 | 2 | 1 | 3 (myNBLDPC/include/define.h:37,
    Simulation.cpp:56-69) — or 'qspa' / 'layered_qspa' / 'glayered_qspa' /
    'glayered_tmm', the exact FFT/Hadamard-domain sum-product and the
    grouped-layered schedules (no reference counterpart; see _qspa_cn_core
    and row_groups)."""
    return jax.jit(functools.partial(decode, code=code, method=method,
                                     max_iters=max_iters, nm=nm, nc=nc,
                                     early_stop=early_stop))
