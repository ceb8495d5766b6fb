"""Jittable device align step + multi-chip sharding.

The flagship device computation: for a batch of reads, run FM-index exact
search, dereference hit rows through the sampled suffix array (bounded LF
walk), fetch the candidate reference window from the device-resident 2-bit
pac, and run banded SW extension — all under one jit, shardable over a 1-D
data mesh with the genome index replicated (collectives only for stats).

This is the device analog of the per-read candidate generation hot path
(reference C hot loops #1-#3, SURVEY.md section 3.2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex
from ..ops.fm_batch import (DeviceFMIndex, backward_ext_batch, lf_batch,
                            occ1_batch, occ4_batch, pac_words_host)
from ..ops.sw_batch import extend_batch


class DeviceGenome(NamedTuple):
    """Device pac + sampled SA alongside the FM arrays."""
    fmd: DeviceFMIndex
    pac_words: jnp.ndarray    # (ceil(l_pac/16),) uint32: 16 bases/word
    sa_samples: jnp.ndarray   # (n_sa,)
    sa_intv: jnp.ndarray      # ()
    l_pac: jnp.ndarray        # ()

    @classmethod
    def from_host(cls, fm: FMIndex) -> "DeviceGenome":
        fmd = DeviceFMIndex.from_host(fm)
        dt = np.int32 if fm.seq_len + 2 < 2**31 else np.int64
        return cls(fmd=fmd,
                   pac_words=jnp.asarray(pac_words_host(fm)),
                   sa_samples=jnp.asarray(fm.sa_samples.astype(dt)),
                   sa_intv=jnp.asarray(dt(fm.sa_intv)),
                   l_pac=jnp.asarray(dt(fm.l_pac)))


def _bwt_code_at(fmd: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Physical BWT code at row k (sentinel-adjusted), batched."""
    kx = jnp.where(k > fmd.primary, k - 1, k)
    word = fmd.fused.reshape(-1)[(kx >> 7) * 12 + 4 + ((kx >> 4) & 7)]
    shift = ((15 - (kx & 15)) * 2).astype(jnp.uint32)
    return ((word >> shift) & 3).astype(jnp.int32)


def sa_lookup_batch(g: DeviceGenome, k: jnp.ndarray,
                    max_steps: int = 512) -> jnp.ndarray:
    """Batched bwt_sa: LF-walk each row until it lands on a sampled row.

    The walk length is unbounded in principle (expected ~sa_intv steps);
    max_steps caps it generously and the while_loop exits as soon as every
    lane has resolved.
    """
    fmd = g.fmd

    def cond(state):
        _, _, done, it = state
        return (~jnp.all(done)) & (it < max_steps)

    def body(state):
        k, steps, done, it = state
        lf = lf_batch(fmd, k)
        lf = jnp.where(k == fmd.primary, 0, lf)
        nk = jnp.where(done, k, lf)
        nsteps = jnp.where(done, steps, steps + 1)
        ndone = done | ((nk % g.sa_intv) == 0)
        return nk, nsteps, ndone, it + 1

    done0 = (k % g.sa_intv) == 0
    k, steps, _, _ = jax.lax.while_loop(
        cond, body, (k, jnp.zeros_like(k), done0, jnp.int32(0)))
    return g.sa_samples[(k // g.sa_intv).astype(jnp.int32)] + steps


@functools.partial(jax.jit, static_argnames=("max_steps",))
def sa_walk_chunk(g: DeviceGenome, k: jnp.ndarray, steps: jnp.ndarray,
                  done: jnp.ndarray, max_steps: int):
    """One bounded stretch of the LF walk; resumable. Returns (k, steps,
    done) packed so stragglers can continue at a narrower width."""
    fmd = g.fmd

    def cond(state):
        _, _, done, it = state
        return (~jnp.all(done)) & (it < max_steps)

    def body(state):
        k, steps, done, it = state
        lf = lf_batch(fmd, k)
        lf = jnp.where(k == fmd.primary, 0, lf)
        nk = jnp.where(done, k, lf)
        nsteps = jnp.where(done, steps, steps + 1)
        ndone = done | ((nk % g.sa_intv) == 0)
        return nk, nsteps, ndone, it + 1

    k, steps, done, _ = jax.lax.while_loop(
        cond, body, (k, steps, done | ((k % g.sa_intv) == 0),
                     jnp.int32(0)))
    return jnp.stack([k, steps, done.astype(k.dtype)], axis=0)


def sa_lookup_batch_host(g: DeviceGenome, fm, rows: np.ndarray,
                         phase_steps: int = 64) -> np.ndarray:
    """Host-orchestrated two-phase SA walk (collect path).

    The while-loop trip count is the MAX walk length over all lanes —
    P(len > t) ~ (1 - 1/sa_intv)^t per lane, so at 64k lanes the longest
    walk runs ~350 LF steps while the mean is ~sa_intv: ~90% of the
    full-width kernel time serves <1% of lanes. Phase A walks everyone
    ``phase_steps``; stragglers continue at a narrow width; the final
    sample add happens on host from the mmapped sa_samples."""
    n = len(rows)
    if n == 0:
        return np.zeros(0, np.int64)
    npad = 128
    while npad < n:
        npad <<= 1
    dt = np.int32 if int(fm.seq_len) + 2 < 2**31 else np.int64
    karr = np.zeros(npad, dt)
    karr[:n] = rows
    out = np.asarray(sa_walk_chunk(
        g, jnp.asarray(karr), jnp.zeros(npad, dt),
        jnp.zeros(npad, bool), phase_steps))
    k, steps, done = np.array(out[0]), out[1], out[2] != 0
    if not done.all():
        idx = np.nonzero(~done)[0]
        ns = 128
        while ns < len(idx):
            ns <<= 1
        ksub = np.zeros(ns, dt)
        ssub = np.zeros(ns, dt)
        dsub = np.ones(ns, bool)
        ksub[:len(idx)] = k[idx]
        ssub[:len(idx)] = steps[idx]
        dsub[:len(idx)] = False
        out2 = np.asarray(sa_walk_chunk(
            g, jnp.asarray(ksub), jnp.asarray(ssub), jnp.asarray(dsub),
            512 - phase_steps))
        k[idx] = out2[0][:len(idx)]
        steps = np.array(steps)
        steps[idx] = out2[1][:len(idx)]
    sa = np.asarray(fm.sa_samples)
    return (sa[(k[:n] // fm.sa_intv).astype(np.int64)]
            + steps[:n].astype(np.int64))


def fetch_window_batch(g: DeviceGenome, start: jnp.ndarray,
                       length: int) -> jnp.ndarray:
    """Gather forward-strand base codes [start, start+length) per batch item.

    Out-of-range positions yield code 4 (N) so they never match.
    """
    # gather at word granularity (16 bases / uint32) then unpack in-register:
    # byte-level gathers are ~16x more gather work
    nwords = (length + 15) // 16 + 1
    first_byte = start >> 2
    pw = g.pac_words
    widx = first_byte[:, None] // 4 + jnp.arange(nwords, dtype=start.dtype)[None, :]
    words = pw[jnp.clip(widx, 0, pw.shape[0] - 1)]       # (B, nwords) uint32
    shifts = jnp.arange(15, -1, -1, dtype=jnp.uint32) * 2
    codes16 = ((words[:, :, None] >> shifts[None, None, :]) & 3)
    codes = codes16.reshape(codes16.shape[0], -1).astype(jnp.int32)
    # realign by the in-word offset (0..15) with 16 static-slice selects
    word_start = (first_byte // 4) * 16
    off = (start - word_start).astype(jnp.int32)          # in [0, 15]
    out = jnp.zeros((codes.shape[0], length), jnp.int32)
    for v in range(16):
        out = jnp.where(off[:, None] == v, codes[:, v:v + length], out)
    pos = start[:, None] + jnp.arange(length, dtype=start.dtype)[None, :]
    valid = (pos >= 0) & (pos < g.l_pac)
    return jnp.where(valid, out, 4)


class AlignStepResult(NamedTuple):
    pos: jnp.ndarray        # (B,) forward-strand hit position (or -1)
    is_rev: jnp.ndarray     # (B,) hit on the reverse strand
    n_hits: jnp.ndarray     # (B,) occurrence count of the best exact seed
    score: jnp.ndarray      # (B,) extension score at the hit
    mapped: jnp.ndarray     # (B,) bool


@functools.partial(jax.jit, static_argnames=("seed_len", "window"))
def align_step(g: DeviceGenome, reads: jnp.ndarray, lens: jnp.ndarray,
               mat: jnp.ndarray, seed_len: int = 32,
               window: int = 32) -> AlignStepResult:
    """One device alignment step: seed by exact suffix match, SA-dereference,
    fetch the implied window, extend to a full-read score.

    reads: (B, L) codes; lens: (B,). The seed is the read's last ``seed_len``
    bases (backward search); the extension scores the full read against the
    implied reference window with band ``window``.
    """
    B, L = reads.shape
    # 1) backward search on the read suffix
    suffix_start = jnp.maximum(lens - seed_len, 0)
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    seed_mask = (idx >= suffix_start[:, None]) & (idx < lens[:, None])
    seed_lens = jnp.minimum(lens, seed_len)
    # re-pack the suffix to the right end so exact_match_batch scans it
    seeds = jnp.where(seed_mask, reads, 4)
    k, l = exact_match_batch_suffix(g.fmd, seeds, suffix_start, lens,
                                    max_iters=seed_len)
    n_hits = jnp.maximum(l - k + 1, 0)
    mapped = n_hits > 0
    # 2) SA lookup of the first hit row
    pos_fmd = sa_lookup_batch(g, jnp.where(mapped, k, 0))
    is_rev = pos_fmd >= g.l_pac
    # doubled-coords start of the whole read implied by the seed hit, then
    # project to the forward strand (reverse hits span [2L-dstart-n, 2L-dstart))
    dstart = pos_fmd - suffix_start.astype(pos_fmd.dtype)
    n64 = lens.astype(pos_fmd.dtype)
    fwd_start = jnp.where(is_rev, 2 * g.l_pac - dstart - n64, dstart)
    # 3) fetch window (read start on-diagonal; slack at the end for indels)
    # and 4) extend the full read, banded
    target = fetch_window_batch(g, fwd_start, L + window)
    # orient the read to the forward strand (revcomp when reversed)
    rev_idx = jnp.clip(lens[:, None] - 1 - idx, 0, L - 1)
    revcomp = jnp.where(
        idx < lens[:, None],
        jnp.where(jnp.take_along_axis(reads, rev_idx, axis=1) < 4,
                  3 - jnp.take_along_axis(reads, rev_idx, axis=1), 4), 4)
    oriented = jnp.where(is_rev[:, None], revcomp, reads)
    ext = extend_batch(
        oriented, lens, target,
        jnp.full((B,), L + window, jnp.int32),
        mat, jnp.full((B,), window, jnp.int32),
        jnp.full((B,), 0, jnp.int32) + 19)
    pos_out = jnp.where(mapped, fwd_start, -1)
    return AlignStepResult(pos=pos_out, is_rev=is_rev & mapped,
                           n_hits=n_hits, score=ext.score, mapped=mapped)


def exact_match_batch_suffix(fmd: DeviceFMIndex, reads: jnp.ndarray,
                             start: jnp.ndarray, lens: jnp.ndarray,
                             max_iters: int = None):
    """Backward search over reads[start:lens) per item."""
    B, L = reads.shape
    dt = fmd.idx_dtype
    k0 = jnp.zeros((B,), dt)
    l0 = jnp.full((B,), fmd.seq_len, dtype=dt)
    span = lens - start
    n_iters = L if max_iters is None else min(L, max_iters)
    # hoist the per-iteration lane gather: one (B, n_iters) gather of the
    # end-aligned reversed codes, then each step reads a static column
    tcols = jnp.arange(n_iters, dtype=jnp.int32)[None, :]
    ridx = jnp.clip(lens[:, None] - 1 - tcols, 0, L - 1).astype(jnp.int32)
    rev = jnp.take_along_axis(reads.astype(jnp.int32), ridx, axis=1)

    def step(t, kl):
        k, l = kl
        c = rev[:, t]
        active = (t < span) & (k <= l) & (c < 4)
        nk, nl = backward_ext_batch(fmd, k, l, jnp.clip(c, 0, 3))
        k = jnp.where(active, nk, k)
        l = jnp.where(active, nl, l)
        return (k, l)

    return jax.lax.fori_loop(0, n_iters, step, (k0, l0))


@functools.partial(jax.jit, static_argnames=("window", "min_seed_len"))
def align_step_smem(g: DeviceGenome, reads: jnp.ndarray, lens: jnp.ndarray,
                    mat: jnp.ndarray, window: int = 32,
                    min_seed_len: int = 19) -> AlignStepResult:
    """One device alignment step with REAL round-1 SMEM seeding.

    Runs the production SMEM enumeration kernel (ops/smem_device.py
    min_starts lanes: minimal start per end position; [b(e), e) is an SMEM
    iff b(e+1) > b(e)), anchors on the longest SMEM (ties: fewest
    occurrences, then leftmost — a chain-weight proxy), SA-walks its first
    occurrence, fetches the implied window and extends the full read.
    Fully jittable: seeding, SA walk, fetch and DP all stay on device.
    """
    from ..ops.smem_device import min_starts_kernel

    B, L = reads.shape
    dt = g.fmd.idx_dtype
    read_idx = jnp.repeat(jnp.arange(B, dtype=jnp.int32), L)
    e_arr = jnp.tile(jnp.arange(1, L + 1, dtype=jnp.int32), B)
    b, x0, x1, s, valid = min_starts_kernel(
        g.fmd, reads, read_idx, e_arr, jnp.ones(B * L, dt), L)
    b = b.reshape(B, L)
    x0 = x0.reshape(B, L)
    s = s.reshape(B, L)
    valid = valid.reshape(B, L)
    e_mat = jnp.arange(1, L + 1, dtype=jnp.int32)[None, :]
    valid = valid & (e_mat <= lens[:, None])
    BIGB = jnp.int32(1 << 30)
    bnext = jnp.concatenate(
        [jnp.where(valid[:, 1:], b[:, 1:], BIGB),
         jnp.full((B, 1), BIGB, jnp.int32)], axis=1)
    length = e_mat - b
    is_smem = valid & (bnext > b) & (length >= min_seed_len)
    # anchor pick: longest, then fewest occurrences, then leftmost
    occ_pen = jnp.minimum(s.astype(jnp.int64), 1 << 20)
    key = jnp.where(is_smem,
                    length.astype(jnp.int64) * (1 << 24) - occ_pen, -1)
    pick = jnp.argmax(key, axis=1)
    mapped = jnp.take_along_axis(is_smem, pick[:, None], axis=1)[:, 0]
    qb = jnp.take_along_axis(b, pick[:, None], axis=1)[:, 0]
    sa_row = jnp.take_along_axis(x0, pick[:, None], axis=1)[:, 0]
    n_hits = jnp.take_along_axis(s, pick[:, None], axis=1)[:, 0]
    # SA walk of the first occurrence -> doubled-coords read start
    pos_fmd = sa_lookup_batch(g, jnp.where(mapped, sa_row, 0))
    dstart = pos_fmd - qb.astype(pos_fmd.dtype)
    is_rev = pos_fmd >= g.l_pac   # strand of the occurrence itself
    n64 = lens.astype(pos_fmd.dtype)
    fwd_start = jnp.where(is_rev, 2 * g.l_pac - dstart - n64, dstart)
    target = fetch_window_batch(g, fwd_start, L + window)
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    rev_idx = jnp.clip(lens[:, None] - 1 - idx, 0, L - 1)
    revcomp = jnp.where(
        idx < lens[:, None],
        jnp.where(jnp.take_along_axis(reads, rev_idx, axis=1) < 4,
                  3 - jnp.take_along_axis(reads, rev_idx, axis=1), 4), 4)
    oriented = jnp.where(is_rev[:, None], revcomp, reads)
    ext = extend_batch(
        oriented, lens, target,
        jnp.full((B,), L + window, jnp.int32),
        mat, jnp.full((B,), window, jnp.int32),
        jnp.full((B,), 0, jnp.int32) + 19)
    pos_out = jnp.where(mapped, fwd_start, -1)
    return AlignStepResult(pos=pos_out, is_rev=is_rev & mapped,
                           n_hits=n_hits, score=ext.score, mapped=mapped)
