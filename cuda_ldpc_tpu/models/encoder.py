"""Systematic LDPC encoders (binary GF(2) and non-binary GF(q)).

The reference ships NO encoder: the binary simulator transmits the all-zero
codeword (bldpc_实习/Simulation.cu:117-128) and the NB simulator a hardcoded
fixture (myNBLDPC/include/codeword_test.h:1, wired at src/main.cu:190-212).
This module adds real encoding so nonzero-codeword simulations with true
syndrome-based termination are possible.

Method: one-time Gaussian elimination of the dense parity-check matrix into
row-reduced form.  The n - rank free columns carry message symbols; the rank
pivot columns are computed as parity = R @ message (over GF(2) / GF(q)).
For binary codes the elimination is bit-packed (uint64 words) and the result
cached under assets/, so even the largest shipped code (J15_L30_Z1280,
m=19200, n=38400) is a one-time ~minutes cost; the per-batch encode itself is
a single f32 matmul mod 2 on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np

from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.utils import gf as gflib
from cuda_ldpc_tpu.utils.registry import ASSETS_DIR


def _bit(Hw: np.ndarray, col: int) -> np.ndarray:
    return (Hw[:, col >> 6] >> np.uint64(63 - (col & 63))) & np.uint64(1)


def _gf2_eliminate(H: np.ndarray):
    """Row-reduce H over GF(2).  Returns (pivot_cols, free_cols, R) with
    R [rank, n_free]: parity[i] = sum_j R[i, j] * msg[j] mod 2."""
    m, n = H.shape
    words = (n + 63) // 64
    Hw = np.zeros((m, words * 64 // 8), dtype=np.uint8)
    Hw[:, : (n + 7) // 8] = np.packbits(H.astype(np.uint8), axis=1)
    Hw = Hw.view(np.uint64)
    Hw = Hw.byteswap()          # big-endian word bit order for _bit()
    r = 0
    pivots = []
    for col in range(n):
        if r >= m:
            break
        bits = _bit(Hw, col)
        nz = np.nonzero(bits[r:])[0]
        if nz.size == 0:
            continue
        p = r + nz[0]
        if p != r:
            Hw[[r, p]] = Hw[[p, r]]
        sel = np.nonzero(_bit(Hw, col))[0]
        sel = sel[sel != r]
        if sel.size:
            Hw[sel] ^= Hw[r]
        pivots.append(col)
        r += 1
    pivots = np.array(pivots, dtype=np.int64)
    free = np.setdiff1d(np.arange(n), pivots)
    # unpack reduced rows at the free columns
    Hb = np.unpackbits(Hw.byteswap().view(np.uint8), axis=1)[:, :n]
    R = Hb[:r][:, free]
    return pivots, free, R.astype(np.uint8)


@dataclasses.dataclass
class BinaryEncoder:
    """Systematic encoder for a binary QC-LDPC code."""
    code: QCBinaryCode
    pivots: np.ndarray   # [rank] parity bit positions
    free: np.ndarray     # [k_eff] message bit positions
    R: np.ndarray        # [rank, k_eff] uint8

    @property
    def k_eff(self) -> int:
        return self.free.size

    @classmethod
    def from_code(cls, code: QCBinaryCode, cache: bool = True):
        path = ASSETS_DIR / f"enc_{code.name}.npz"
        if cache and path.exists():
            with np.load(path) as d:
                return cls(code, d["pivots"], d["free"],
                           np.unpackbits(d["Rp"], axis=1)[:, : d["free"].size])
        pivots, free, R = _gf2_eliminate(code.dense_H)
        if cache:
            ASSETS_DIR.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(path, pivots=pivots, free=free,
                                Rp=np.packbits(R, axis=1))
        return cls(code, pivots, free, R)

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg [..., k_eff] bits -> codeword [..., n] bits (numpy)."""
        msg = np.asarray(msg, dtype=np.uint8)
        par = (msg @ self.R.T) & 1
        cw = np.zeros(msg.shape[:-1] + (self.code.n,), dtype=np.uint8)
        cw[..., self.free] = msg
        cw[..., self.pivots] = par
        return cw

    def encode_jax(self, msg):
        """Batched device encode: f32 matmul mod 2.

        Exact at any matmul precision, so no ``precision`` is asked for: the
        operands are 0/1, which TF32 and bf16 represent exactly, and the
        products accumulate in f32, exact for integer sums below 2^24
        (at most k_eff terms).  chip_smoke.py checks it bit-exact against
        ``encode`` on the GPU."""
        import jax.numpy as jnp

        msg = jnp.asarray(msg, dtype=jnp.float32)
        Rt = jnp.asarray(self.R.T, dtype=jnp.float32)
        par = jnp.mod(msg @ Rt, 2.0)
        cw = jnp.zeros(msg.shape[:-1] + (self.code.n,), dtype=jnp.float32)
        cw = cw.at[..., jnp.asarray(self.free)].set(msg)
        cw = cw.at[..., jnp.asarray(self.pivots)].set(par)
        return cw.astype(jnp.int8)


@dataclasses.dataclass
class NBEncoder:
    """Systematic encoder for a non-binary GF(q) code."""
    code: NBCode
    pivots: np.ndarray
    free: np.ndarray
    R: np.ndarray        # [rank, k_eff] GF coefficients: parity = R . msg

    @property
    def k_eff(self) -> int:
        return self.free.size

    @classmethod
    def from_code(cls, code: NBCode, cache: bool = True):
        path = ASSETS_DIR / f"enc_nb_{code.name}.npz"
        if cache and path.exists():
            with np.load(path) as d:
                return cls(code, d["pivots"], d["free"],
                           d["R"].astype(np.int64))
        q = code.q
        mul, inv = code.mul_table, code.inv_table
        # dense H over GF(q)
        H = np.zeros((code.m_sym, code.n_sym), dtype=np.int64)
        for m in range(code.m_sym):
            for d in range(code.cn_weight[m]):
                H[m, code.cn_links[m, d]] = code.cn_gf[m, d]
        r = 0
        pivots = []
        for col in range(code.n_sym):
            if r >= code.m_sym:
                break
            nz = np.nonzero(H[r:, col])[0]
            if nz.size == 0:
                continue
            p = r + nz[0]
            if p != r:
                H[[r, p]] = H[[p, r]]
            H[r] = mul[inv[H[r, col]], H[r]]          # scale row to pivot 1
            sel = np.nonzero(H[:, col])[0]
            sel = sel[sel != r]
            if sel.size:                              # vectorized row ops
                H[sel] ^= mul[H[sel, col][:, None], H[r][None, :]]
            pivots.append(col)
            r += 1
        pivots = np.array(pivots, dtype=np.int64)
        free = np.setdiff1d(np.arange(code.n_sym), pivots)
        R = H[:r][:, free]
        if cache:
            ASSETS_DIR.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(path, pivots=pivots, free=free,
                                R=R.astype(np.uint8 if q <= 256 else np.int64))
        return cls(code, pivots, free, R)

    @functools.cached_property
    def _bit_matrix(self) -> np.ndarray:
        """GF(2^m) is an m-dimensional GF(2) vector space and multiplication
        by a constant is GF(2)-linear, so the whole parity map expands to ONE
        binary matrix over message BITS: Rb[i*m+t, j*m+s] = bit t of
        mul(R[i,j], 2^s).  parity_bits = msg_bits @ Rb.T mod 2 — a single
        matmul per batch on device (the reference has no encoder at all;
        myNBLDPC/src/LDPC_Encoder.cpp:6-36 only packs bits of a fixture)."""
        m = self.code.q_bit
        mul = self.code.mul_table
        rank, k_eff = self.R.shape
        Rb = np.zeros((rank * m, k_eff * m), dtype=np.uint8)
        for s in range(m):
            contrib = mul[self.R, 1 << s]                 # [rank, k_eff]
            for t in range(m):
                Rb[t::m, s::m] = (contrib >> t) & 1
        return Rb

    def encode_jax(self, msg_bits):
        """Batched device encode from message BITS.

        msg_bits: [..., k_eff * q_bit] float32 in {0, 1}, LSB-first per
        symbol (bit s of free symbol j at index j*q_bit + s — the reference's
        BitToSym packing, myNBLDPC/src/LDPC_Encoder.cpp:6-17).  Returns
        codeword SYMBOLS [..., N] int32.  The parity matmul runs in bf16
        storage with f32 accumulation, exact at any matmul precision: 0/1
        operands are exact in bf16 and the integer sums stay below 2^24.
        chip_smoke.py checks it bit-exact against ``encode`` on the GPU."""
        import jax.numpy as jnp

        m = self.code.q_bit
        Rb = jnp.asarray(self._bit_matrix.T, dtype=jnp.bfloat16)
        mb = jnp.asarray(msg_bits, dtype=jnp.bfloat16)
        par_bits = jnp.mod(
            jnp.matmul(mb, Rb, preferred_element_type=jnp.float32), 2.0)
        w = jnp.asarray([1 << s for s in range(m)], dtype=jnp.int32)
        msyms = jnp.sum(msg_bits.reshape(msg_bits.shape[:-1] + (-1, m))
                        .astype(jnp.int32) * w, axis=-1)
        psyms = jnp.sum(par_bits.reshape(par_bits.shape[:-1] + (-1, m))
                        .astype(jnp.int32) * w, axis=-1)
        cw = jnp.zeros(msg_bits.shape[:-1] + (self.code.n_sym,), jnp.int32)
        cw = cw.at[..., jnp.asarray(self.free)].set(msyms)
        cw = cw.at[..., jnp.asarray(self.pivots)].set(psyms)
        return cw

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """msg [..., k_eff] GF symbols -> codeword [..., N] symbols.
        Parity p solves H c = 0: with reduced rows, p_i = sum R[i,j] msg_j
        (GF), since row i reads c[pivot_i] + sum_j R[i,j] c[free_j] = 0 and
        GF(2^m) addition is its own inverse."""
        msg = np.asarray(msg, dtype=np.int64)
        mul = self.code.mul_table
        par = np.zeros(msg.shape[:-1] + (self.pivots.size,), dtype=np.int64)
        for j in range(self.free.size):
            contrib = mul[self.R[:, j], msg[..., j, None]]
            par ^= contrib
        cw = np.zeros(msg.shape[:-1] + (self.code.n_sym,), dtype=np.int64)
        cw[..., self.free] = msg
        cw[..., self.pivots] = par
        return cw
