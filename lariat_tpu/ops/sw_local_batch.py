"""Batched local Smith-Waterman (mate rescue DP) on device (JAX/XLA).

Computes the forward direction of ksw_align2 (KSW_XSTART|KSW_XSUBO semantics,
see ``lariat_tpu/align/ksw.py:_local_core``) for a whole batch of
(query, target) tasks: per task it returns the best local score, its
(te, qe) end coordinates, and the second-best score outside a
``(score+max_match-1)//max_match`` column radius of the best — including
bwa's merged-consecutive-column quirk for the candidate list (ksw.c's
``b`` array: a run of consecutive columns >= minsc is one candidate whose
stored index is the last column that strictly raised the run maximum).

The start coordinates (qb, tb) come from a second batched call on the
reversed prefixes (``align/ksw.py:local_align_batch`` orchestrates the two
waves); the reference consumer is mate rescue (engine.py:mate_rescue,
reference gobwa.go:287-324 / bwa's mem_matesw).

Exact-parity contract: bit-identical to ``ksw.local_align`` per task
(asserted by tests/test_sw_local.py fuzz batteries).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = -0x40000000


class LocalBatchResult(NamedTuple):
    score: jnp.ndarray   # (B,) int32 best local score (gmax)
    te: jnp.ndarray      # (B,) inclusive target end, -1 if no positive cell
    qe: jnp.ndarray      # (B,) inclusive query end (first argmax in column te)
    score2: jnp.ndarray  # (B,) second-best outside the radius, -1 if none
    te2: jnp.ndarray     # (B,) its column, -1 if none


@functools.partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins",
                                             "e_ins", "max_sc"))
def local_batch(query: jnp.ndarray, qlen: jnp.ndarray,
                target: jnp.ndarray, tlen: jnp.ndarray,
                mat: jnp.ndarray, minsc: jnp.ndarray,
                o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                e_ins: int = 1, max_sc: int = 1) -> LocalBatchResult:
    """Batched forward local SW.

    query: (B, Lq) codes 0..4, padded arbitrarily past qlen
    qlen:  (B,) query lengths (0 allowed -> all-zero result row)
    target:(B, Lt) codes padded past tlen
    tlen:  (B,) target lengths
    mat:   (5, 5) scoring matrix; ``max_sc`` must equal mat.max() (static,
           sets the second-best exclusion radius divisor)
    minsc: (B,) minimum column score for second-best candidate tracking
    """
    B, Lq = query.shape
    Lt = target.shape[1]
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    minsc = minsc.astype(jnp.int32)
    mat = mat.astype(jnp.int32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    jr = jnp.arange(Lq, dtype=jnp.int32)[None, :]        # (1, Lq)
    qvalid = jr < qlen[:, None]                          # (B, Lq)
    qsub = mat[:, query.reshape(-1)].reshape(5, B, Lq)   # score profile

    class _S(NamedTuple):
        H: jnp.ndarray        # (B, Lq) previous row
        E: jnp.ndarray        # (B, Lq)
        colmax: jnp.ndarray   # (B, Lt) per-column maxima
        gmax: jnp.ndarray     # (B,)
        te: jnp.ndarray
        qe: jnp.ndarray

    init = _S(jnp.zeros((B, Lq), jnp.int32), jnp.zeros((B, Lq), jnp.int32),
              jnp.zeros((B, Lt), jnp.int32),
              jnp.zeros((B,), jnp.int32),
              jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32))

    def row_step(i, s: _S) -> _S:
        i32 = jnp.int32(i)
        in_row = i32 < tlen                              # (B,)
        tcode = target[:, jnp.minimum(i32, Lt - 1)]
        sub = jnp.take_along_axis(
            qsub, tcode[None, :, None].astype(jnp.int32), axis=0)[0]
        diag = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), s.H[:, :-1]], axis=1)
        M = diag + sub
        H0 = jnp.maximum(jnp.maximum(M, s.E), 0)
        # F[j] = max(0, max_{k<j}(max(H0[k]-oe_ins, 0) - (j-1-k)*e_ins))
        src = jnp.maximum(H0 - oe_ins, 0)
        a = src + jr * e_ins
        run = jax.lax.associative_scan(jnp.maximum, a, axis=1)
        F = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32),
             run[:, :-1] - jr[:, :-1] * e_ins], axis=1)
        F = jnp.maximum(F, 0)
        H = jnp.maximum(H0, F)
        H = jnp.where(qvalid, H, 0)
        E = jnp.maximum(jnp.maximum(s.E - e_del, H - oe_del), 0)
        col_max = jnp.max(H, axis=1)
        col_max = jnp.where(in_row, col_max, 0)
        colmax = jax.lax.dynamic_update_slice(
            s.colmax, col_max[:, None], (0, i))
        improved = in_row & (col_max > s.gmax)
        qe_row = jnp.argmax(H, axis=1).astype(jnp.int32)  # first occurrence
        return _S(jnp.where(in_row[:, None], H, s.H),
                  jnp.where(in_row[:, None], E, s.E),
                  colmax,
                  jnp.where(improved, col_max, s.gmax),
                  jnp.where(improved, i32, s.te),
                  jnp.where(improved, qe_row, s.qe))

    f = jax.lax.fori_loop(0, Lt, row_step, init)

    # second best: replay ksw.c's merged-candidate list over the column maxima
    radius = (f.gmax + (max_sc - 1)) // jnp.int32(max_sc)
    low = f.te - radius
    high = f.te + radius

    class _S2(NamedTuple):
        run_max: jnp.ndarray   # (B,) open candidate max (-1 = none)
        run_idx: jnp.ndarray   # (B,) its stored column (-2 = none)
        score2: jnp.ndarray
        te2: jnp.ndarray

    def _finalize(s2: _S2) -> _S2:
        outside = (s2.run_idx < low) | (s2.run_idx > high)
        use = (s2.run_idx >= 0) & outside & (s2.run_max > s2.score2)
        return _S2(s2.run_max, s2.run_idx,
                   jnp.where(use, s2.run_max, s2.score2),
                   jnp.where(use, s2.run_idx, s2.te2))

    def col_step(i, s2: _S2) -> _S2:
        i32 = jnp.int32(i)
        cm = jax.lax.dynamic_slice(f.colmax, (0, i), (B, 1))[:, 0]
        valid = (i32 < tlen) & (cm >= minsc)
        is_new = valid & (s2.run_idx + 1 != i32)
        fin = _finalize(s2)
        run_max = jnp.where(is_new, cm, s2.run_max)
        run_idx = jnp.where(is_new, i32, s2.run_idx)
        # continuation that raises the run max re-stamps the index
        raises = valid & (~is_new) & (s2.run_max < cm)
        run_max = jnp.where(raises, cm, run_max)
        run_idx = jnp.where(raises, i32, run_idx)
        return _S2(run_max, run_idx,
                   jnp.where(is_new, fin.score2, s2.score2),
                   jnp.where(is_new, fin.te2, s2.te2))

    s2 = jax.lax.fori_loop(
        0, Lt, col_step,
        _S2(jnp.full((B,), -1, jnp.int32), jnp.full((B,), -2, jnp.int32),
            jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32)))
    s2 = _finalize(s2)

    none = f.te < 0
    return LocalBatchResult(
        score=jnp.where(none, 0, f.gmax),
        te=f.te, qe=jnp.where(none, -1, f.qe),
        score2=s2.score2, te2=s2.te2)


def _rev_prefix(x: jnp.ndarray, end: jnp.ndarray) -> jnp.ndarray:
    """rev[b, j] = x[b, end[b] - j] for j <= end[b], else 0 (end inclusive)."""
    L = x.shape[1]
    idx = end[:, None] - jnp.arange(L, dtype=jnp.int32)[None, :]
    take = jnp.take_along_axis(x, jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(idx >= 0, take, 0)


@functools.partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins",
                                             "e_ins", "max_sc"))
def local_two_pass(query: jnp.ndarray, qlen: jnp.ndarray,
                   target: jnp.ndarray, tlen: jnp.ndarray,
                   mat: jnp.ndarray, minsc: jnp.ndarray,
                   o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                   e_ins: int = 1, max_sc: int = 1) -> jnp.ndarray:
    """Full ksw_align2 (forward pass + reversed start pass) in one dispatch.

    Returns a packed (8, B) int32 buffer:
        rows: score, te, qe, score2, te2, qe_r, te_r, scored(0/1)
    """
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    minsc = minsc.astype(jnp.int32)
    r1 = local_batch(query, qlen, target, tlen, mat, minsc,
                     o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                     max_sc=max_sc)
    scored = (r1.te >= 0) & (r1.score >= minsc)
    q2 = _rev_prefix(query, r1.qe)
    t2 = _rev_prefix(target, r1.te)
    qlen2 = jnp.where(scored, r1.qe + 1, 0)
    tlen2 = jnp.where(scored, r1.te + 1, 0)
    big = jnp.full_like(minsc, 1 << 30)
    r2 = local_batch(q2, qlen2, t2, tlen2, mat, big,
                     o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                     max_sc=max_sc)
    zero = jnp.zeros_like(r1.score)
    return jnp.stack([r1.score, r1.te, r1.qe, r1.score2, r1.te2,
                      r2.qe, r2.te, scored.astype(jnp.int32) + zero])
