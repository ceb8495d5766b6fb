"""Batched Smith-Waterman extension on device (JAX/XLA).

Computes ksw_extend2 (see ``lariat_tpu/align/ksw.py``) for a whole batch of
(query, target) tasks at once: the DP is sequential over target rows only;
within a row every query position is independent (gap opens come from the
diagonal M term in BWA's recurrence), so each row is elementwise VPU work of
shape (batch, Lq) plus one prefix-max scan along the query axis for F.

Layout: (B, Lq) row planes, batch-major.

Exact-parity notes vs the scalar reference implementation:
 - early 'break' rows become masked no-ops (an ``alive`` flag per task);
 - the in-band/out-of-band boundary writes (eh[end], h1 carries) are
   reproduced via band masks;
 - tie-breaks (last argmax in row; strictly-greater across rows) identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = -0x40000000


class ExtendBatchResult(NamedTuple):
    score: jnp.ndarray    # (B,) int32
    qle: jnp.ndarray      # (B,)
    tle: jnp.ndarray      # (B,)
    gtle: jnp.ndarray     # (B,)
    gscore: jnp.ndarray   # (B,)
    max_off: jnp.ndarray  # (B,)


def _adjust_w(qlen, w, max_sc, end_bonus, o_ins, e_ins, o_del, e_del):
    max_ins = ((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0).astype(jnp.int32)
    max_ins = jnp.maximum(max_ins, 1)
    max_del = ((qlen * max_sc + end_bonus - o_del) / e_del + 1.0).astype(jnp.int32)
    max_del = jnp.maximum(max_del, 1)
    return jnp.minimum(jnp.minimum(w, max_ins), max_del)


@functools.partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins", "e_ins",
                                             "end_bonus", "zdrop", "match_sc",
                                             "packed"))
def extend_batch(query: jnp.ndarray, qlen: jnp.ndarray,
                 target: jnp.ndarray, tlen: jnp.ndarray,
                 mat: jnp.ndarray, w: jnp.ndarray, h0: jnp.ndarray,
                 o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                 e_ins: int = 1, end_bonus: int = 5, zdrop: int = 100,
                 match_sc: int = 1, packed: bool = False) -> ExtendBatchResult:
    """Batched ksw_extend2.

    query: (B, Lq) int8/int32 codes (0..4), padded arbitrarily past qlen
    qlen:  (B,) actual query lengths (0 allowed)
    target:(B, Lt) codes padded past tlen
    tlen:  (B,) actual target lengths
    mat:   (5, 5) int32 scoring matrix
    w:     (B,) band width per task
    h0:    (B,) initial score per task
    """
    B, Lq = query.shape
    Lt = target.shape[1]
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    w = w.astype(jnp.int32)
    h0 = h0.astype(jnp.int32)
    mat = mat.astype(jnp.int32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    max_sc = jnp.int32(mat.max())
    w = _adjust_w(qlen, w, max_sc, end_bonus, o_ins, e_ins, o_del, e_del)

    jidx = jnp.arange(Lq + 1, dtype=jnp.int32)[None, :]   # (1, Lq+1)
    qmask = jidx[:, :Lq] < qlen[:, None]                  # (B, Lq) valid qpos

    # first row: eh_h[j] = H(-1, j-1) diagonal inits
    # eh_h[0]=h0; eh_h[1]=max(h0-oe_ins,0); eh_h[j]=eh_h[j-1]-e_ins while >e_ins
    # closed form: eh_h[j] = h0 - oe_ins - (j-1)*e_ins for j>=1 (floored compat)
    j1 = jnp.maximum(jidx - 1, 0)
    row0 = h0[:, None] - oe_ins - j1 * e_ins
    row0 = jnp.where(jidx == 0, h0[:, None], row0)
    # replicate the exact cutoff: values stop once h <= e_ins (rest stay 0)
    # eh[1] = h0>oe_ins ? h0-oe_ins : 0; chain continues while prev > e_ins
    valid_chain = row0 > 0
    # positions beyond the first non-positive value are 0; since row0 is
    # strictly decreasing in j (e_ins>0), the simple floor matches the loop
    row0 = jnp.where(valid_chain, row0, 0)
    row0 = jnp.where((jidx == 1) & (h0[:, None] <= oe_ins), 0, row0)
    row0 = jnp.where(jidx <= qlen[:, None], row0, 0)
    eh_h0 = row0.astype(jnp.int32)                         # (B, Lq+1)
    eh_e0 = jnp.zeros((B, Lq + 1), jnp.int32)

    qsub = mat[:, query.reshape(-1)].reshape(5, B, Lq)     # (5, B, Lq) profile

    class _S(NamedTuple):
        eh_h: jnp.ndarray
        eh_e: jnp.ndarray
        alive: jnp.ndarray
        max_score: jnp.ndarray
        max_i: jnp.ndarray
        max_j: jnp.ndarray
        max_ie: jnp.ndarray
        gscore: jnp.ndarray
        max_off: jnp.ndarray

    init = _S(eh_h0, eh_e0, (tlen > 0) & (qlen > 0), h0,
              jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32),
              jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32),
              jnp.zeros((B,), jnp.int32))

    jr = jnp.arange(Lq, dtype=jnp.int32)[None, :]          # (1, Lq)

    def row_step(i, s: _S) -> _S:
        i32 = jnp.int32(i)
        in_row = s.alive & (i32 < tlen)
        beg = jnp.maximum(i32 - w, 0)                       # (B,)
        end = jnp.minimum(i32 + w + 1, qlen)                # (B,)
        band = (jr >= beg[:, None]) & (jr < end[:, None])   # (B, Lq)
        h1_init = jnp.where(beg == 0,
                            jnp.maximum(h0 - (o_del + e_del * (i32 + 1)), 0),
                            0)
        tcode = target[:, jnp.minimum(i32, Lt - 1)]         # (B,)
        sub = jnp.take_along_axis(
            qsub, tcode[None, :, None].astype(jnp.int32), axis=0)[0]  # (B, Lq)
        M = s.eh_h[:, :Lq]
        E = s.eh_e[:, :Lq]
        M = jnp.where(M != 0, M + sub, 0)
        M = jnp.where(band, M, 0)
        mfloor = jnp.maximum(M - oe_ins, 0)
        # F scan: F[j] = max(0, max_{k<j, k>=beg}(mfloor[k] - (j-1-k)*e_ins));
        # out-of-band cells contribute -inf
        a = jnp.where(band, mfloor + jr * e_ins, NEG)
        run = jax.lax.associative_scan(jnp.maximum, a, axis=1)
        F = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), run[:, :-1] - (jr[:, :-1]) * e_ins],
            axis=1)
        F = jnp.maximum(F, 0)
        F = jnp.where(jr == beg[:, None], 0, F)
        h = jnp.maximum(jnp.maximum(M, jnp.where(band, E, 0)), F)
        h = jnp.where(band, h, 0)
        # gscore check when end == qlen: h at column end-1
        h_last = jnp.take_along_axis(
            h, jnp.maximum(end - 1, 0)[:, None], axis=1)[:, 0]
        # C's post-loop check is `j == qlen` with j = end (non-empty band)
        # or j = beg (empty band, h1 = 0 side-effect)
        nonempty = beg < end
        at_qend = in_row & jnp.where(nonempty, end == qlen, beg == qlen)
        h_last = jnp.where(nonempty, h_last, 0)
        better_g = at_qend & (s.gscore < h_last)
        gscore = jnp.where(better_g, h_last, s.gscore)
        max_ie = jnp.where(better_g, i32, s.max_ie)
        # row max, last argmax (C tie-break takes larger j on ties)
        m_best = jnp.max(jnp.where(band, h, 0), axis=1)
        rev_arg = jnp.argmax(jnp.where(band, h, 0)[:, ::-1], axis=1)
        mj = (Lq - 1 - rev_arg).astype(jnp.int32)
        improved = in_row & (m_best > s.max_score)
        new_off = jnp.maximum(s.max_off, jnp.abs(mj - i32))
        max_off = jnp.where(improved, new_off, s.max_off)
        max_score = jnp.where(improved, m_best, s.max_score)
        max_i = jnp.where(improved, i32, s.max_i)
        max_j = jnp.where(improved, mj, s.max_j)
        # zdrop termination (only when not improved)
        di = i32 - s.max_i
        dj = mj - s.max_j
        zcond = jnp.where(
            di > dj,
            s.max_score - m_best - (di - dj) * e_del > zdrop,
            s.max_score - m_best - (dj - di) * e_ins > zdrop)
        died = in_row & ((m_best == 0) | ((~improved) & zcond))
        alive = s.alive & (i32 + 1 < tlen) & ~died
        # write-back eh arrays: eh_h[j] <- H(i, j-1) inside (beg, end];
        # eh_h[beg] <- h1_init; eh_e[j] <- E(i+1,j) in [beg,end); eh_e[end]=0
        h_shift = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), h], axis=1)       # H(i, j-1) at j
        wmask = (jidx > beg[:, None]) & (jidx <= end[:, None])
        eh_h = jnp.where(wmask, h_shift, s.eh_h)
        eh_h = jnp.where(jidx == beg[:, None], h1_init[:, None], eh_h)
        e_new = jnp.maximum(E - e_del, jnp.maximum(M - oe_del, 0))
        e_pad = jnp.concatenate([e_new, jnp.zeros((B, 1), jnp.int32)], axis=1)
        emask = (jidx >= beg[:, None]) & (jidx < end[:, None])
        eh_e = jnp.where(emask, e_pad, s.eh_e)
        eh_e = jnp.where(jidx == end[:, None], 0, eh_e)
        # freeze state for rows not active
        keep = in_row
        eh_h = jnp.where(keep[:, None], eh_h, s.eh_h)
        eh_e = jnp.where(keep[:, None], eh_e, s.eh_e)
        return _S(eh_h, eh_e,
                  jnp.where(keep, alive, s.alive),
                  jnp.where(keep, max_score, s.max_score),
                  jnp.where(keep, max_i, s.max_i),
                  jnp.where(keep, max_j, s.max_j),
                  jnp.where(keep, max_ie, s.max_ie),
                  jnp.where(keep, gscore, s.gscore),
                  jnp.where(keep, max_off, s.max_off))

    final = jax.lax.fori_loop(0, Lt, row_step, init)
    empty = qlen == 0
    res = ExtendBatchResult(
        score=jnp.where(empty, h0, final.max_score),
        qle=jnp.where(empty, 0, final.max_j + 1),
        tle=jnp.where(empty, 0, final.max_i + 1),
        gtle=jnp.where(empty, 0, final.max_ie + 1),
        gscore=jnp.where(empty, h0, final.gscore),
        max_off=jnp.where(empty, 0, final.max_off))
    if packed:
        # single (6, B) buffer: one device->host transfer per wave
        return jnp.stack(list(res))
    return res
