"""Independent NumPy oracles (dense-H formulations) used to validate the
jnp/Pallas decoders.  Deliberately written against the *mathematical* spec, not
the reference's memory layout, so agreement is meaningful."""

from __future__ import annotations

import numpy as np


def minsum_flooding_dense(llr: np.ndarray, H: np.ndarray, num_iters: int,
                          alpha: float = 1.0, beta: float = 0.0):
    """Flooding min-sum on a dense parity-check matrix.

    llr: [n] channel LLRs (positive = bit 0).  Returns (hard [n], total [n],
    iters, ok) with the same schedule as the jnp decoder: per iteration
    VN (totals + hard) -> syndrome check -> CN; stops when H.hard == 0.
    """
    m, n = H.shape
    rows = [np.nonzero(H[i])[0] for i in range(m)]
    R = np.zeros((m, n))
    hard = np.zeros(n, dtype=bool)
    total = llr.copy()
    it = 0
    ok = False
    while it < num_iters and not ok:
        it += 1
        total = llr + R.sum(axis=0)
        hard = total < 0
        Q = np.where(H > 0, total[None, :] - R, 0.0)
        for i in range(m):
            vs = rows[i]
            q = Q[i, vs]
            sgn = np.where(q < 0, -1.0, 1.0)
            mag = np.abs(q)
            sp = np.prod(sgn)
            amin = int(np.argmin(mag))
            min1 = mag[amin]
            rest = np.delete(mag, amin)
            min2 = rest.min()
            out = np.where(np.arange(len(vs)) == amin, min2, min1)
            if beta:
                out = np.maximum(out - beta, 0.0)
            R[i, vs] = alpha * sp * sgn * out
        ok = not np.any((H @ hard.astype(np.int64)) % 2)
    return hard, total, it, ok


def bp_flooding_dense(llr: np.ndarray, H: np.ndarray, num_iters: int):
    """Flooding exact sum-product (tanh rule) on a dense parity-check matrix,
    float64 tanh-product form R_i = 2 atanh(prod_{j!=i} tanh(Q_j/2)) —
    deliberately a different algebraic form from the decoder's phi-domain
    sign/magnitude formulation so agreement is meaningful.

    llr: [n] true channel LLRs.  Returns (hard [n], total [n], iters, ok)
    with the same schedule as the jnp decoder.
    """
    m, n = H.shape
    rows = [np.nonzero(H[i])[0] for i in range(m)]
    R = np.zeros((m, n))
    hard = np.zeros(n, dtype=bool)
    total = llr.copy()
    it = 0
    ok = False
    tiny = 1e-300
    while it < num_iters and not ok:
        it += 1
        total = llr + R.sum(axis=0)
        hard = total < 0
        Q = np.where(H > 0, total[None, :] - R, 0.0)
        for i in range(m):
            vs = rows[i]
            t = np.tanh(np.clip(Q[i, vs], -34.0, 34.0) / 2.0)
            t = np.where(np.abs(t) < tiny, tiny, t)
            prod_all = np.prod(t)
            r = np.clip(prod_all / t, -1 + 1e-15, 1 - 1e-15)
            R[i, vs] = 2.0 * np.arctanh(r)
        ok = not np.any((H @ hard.astype(np.int64)) % 2)
    return hard, total, it, ok


def _cn_rule_row(q: np.ndarray, rule: str, alpha: float,
                 beta: float) -> np.ndarray:
    """One check row's c2v messages from its v2c messages ``q``."""
    sgn = np.where(q < 0, -1.0, 1.0)
    sp = np.prod(sgn)
    if rule == "minsum":
        mag = np.abs(q)
        amin = int(np.argmin(mag))
        out = np.where(np.arange(len(q)) == amin,
                       np.delete(mag, amin).min(), mag[amin])
    else:                       # tanh rule, float64, no phi-domain clipping
        t = np.tanh(np.clip(np.abs(q), 1e-12, 34.0) / 2.0)
        out = 2.0 * np.arctanh(np.clip(np.prod(t) / t, 0.0, 1 - 1e-15))
    if beta:
        out = np.maximum(out - beta, 0.0)
    return alpha * sp * sgn * out


def decode_history(llr: np.ndarray, H: np.ndarray, num_iters: int,
                   schedule: str = "flooding", rule: str = "minsum",
                   alpha: float = 1.0, beta: float = 0.0) -> list:
    """Hard decisions [n] bool after each of ``num_iters`` iterations, with
    no early stop, row by row on a dense parity-check matrix.

    flooding: iteration t decides from llr + all c2v of iteration t-1, then
    updates every check row from those totals (the jnp decoder's order:
    VN phase, decision, CN phase).  layered: rows update in ascending order,
    each writing its change back to the totals at once; iteration t decides
    from the totals after the sweep.  Rows of one QC block row share no
    variable, so this serial order equals the decoder's block-row-parallel
    one.  Both schedules match the decoder bit for bit on min-sum inputs
    that are small multiples of a power of two (all sums exact in f32)."""
    m, n = H.shape
    rows = [np.nonzero(H[i])[0] for i in range(m)]
    R = [np.zeros(len(vs)) for vs in rows]
    llr = llr.astype(np.float64)
    hist = []
    if schedule == "flooding":
        for _ in range(num_iters):
            total = llr.copy()
            for vs, r in zip(rows, R):
                total[vs] += r
            hist.append(total < 0)
            R = [_cn_rule_row(total[vs] - r, rule, alpha, beta)
                 for vs, r in zip(rows, R)]
        return hist
    total = llr.copy()
    for _ in range(num_iters):
        for i, vs in enumerate(rows):
            new = _cn_rule_row(total[vs] - R[i], rule, alpha, beta)
            total[vs] += new - R[i]
            R[i] = new
        hist.append(total < 0)
    return hist
