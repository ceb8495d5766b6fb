"""Device-resident wave feeds: build DP inputs on device from descriptors.

Instead of uploading fully-materialized (B, Lq) query and (B, Lt) target
matrices per wave (~25 MB for a 16k-task extend wave), this module keeps
the group's reads and the 2-bit pac genome resident in device memory and
reconstructs each wave's q/t tiles on device from ~48-byte task
descriptors:

  query  = reads[rid, qstart + j*qdir]          (slice, optionally reversed)
  target = fmd_code(tstart + i*tdir)            (doubled-text fetch,
                                                 gobwa.go:50-80 semantics)

Out-of-range positions yield code 4 (N); the DP kernels mask by qlen/tlen
so pad content never matters. Reference: mem_chain2aln's left/right
extension windows (SURVEY.md section 2.2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class ResidentReads(NamedTuple):
    codes: jnp.ndarray     # (N, L) uint8, 4-padded
    n: int
    L: int


def put_reads(qs) -> ResidentReads:
    """Upload a group's encoded reads once (uint8, 4-padded).

    The row count pads to a power of two (>= 256) and the length to a
    64-multiple: the matrix shape is part of every wave's compile key, and
    an exact read count would recompile the waves for every batch."""
    import numpy as np
    N = len(qs)
    L = max((len(q) for q in qs), default=1)
    L = max(-(-L // 64) * 64, 64)
    rows = 256
    while rows < N:
        rows <<= 1
    m = np.full((rows, L), 4, np.uint8)
    for i, q in enumerate(qs):
        m[i, :len(q)] = q
    return ResidentReads(codes=jax.device_put(jnp.asarray(m)), n=N, L=L)


def gather_reads(reads: jnp.ndarray, rid: jnp.ndarray, qstart: jnp.ndarray,
                 qdir: jnp.ndarray, Lq: int) -> jnp.ndarray:
    """(B, Lq) int32 codes of reads[rid, qstart + j*qdir]; OOR -> 4."""
    N, L = reads.shape
    j = jnp.arange(Lq, dtype=jnp.int32)[None, :]
    pos = qstart[:, None].astype(jnp.int32) + j * qdir[:, None].astype(
        jnp.int32)
    inb = (pos >= 0) & (pos < L)
    flat = rid[:, None].astype(jnp.int32) * L + jnp.clip(pos, 0, L - 1)
    out = jnp.take(reads.reshape(-1), flat).astype(jnp.int32)
    return jnp.where(inb, out, 4)


def fetch_fmd_batch(pac_words: jnp.ndarray, l_pac, tstart: jnp.ndarray,
                    tdir: jnp.ndarray, Lt: int) -> jnp.ndarray:
    """(B, Lt) int32 codes of the doubled (FMD) text at tstart + i*tdir.

    Positions >= l_pac mirror to the reverse complement (bns_fetch_seq
    over the doubled space); out-of-range -> 4. Word-granularity gather
    (16 bases/uint32) like align_step.fetch_window_batch, but per-element
    offsets (tasks are unaligned and may run backwards).
    """
    dt = tstart.dtype
    i = jnp.arange(Lt, dtype=dt)[None, :]
    p = tstart[:, None] + i * tdir[:, None].astype(dt)
    l_pac = jnp.asarray(l_pac, dt)
    inb = (p >= 0) & (p < 2 * l_pac)
    is_rev = p >= l_pac
    fwd = jnp.where(is_rev, 2 * l_pac - 1 - p, p)
    fwd = jnp.clip(fwd, 0, l_pac - 1)
    widx = (fwd >> 4).astype(jnp.int32)
    words = jnp.take(pac_words, widx)
    sh = ((15 - (fwd & 15)).astype(jnp.uint32) * 2)
    c = ((words >> sh) & 3).astype(jnp.int32)
    c = jnp.where(is_rev, 3 - c, c)
    return jnp.where(inb, c, 4)


# packed task-descriptor layout: ONE (B, 9) device upload per wave instead
# of nine small ones.
# cols: [rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w]
D_RID, D_QS, D_QD, D_QL, D_TS, D_TD, D_TL, D_H0, D_W = range(9)


def pack_desc(rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
              l_pac: int):
    """Stack descriptors into one (B, 9) int32/int64 matrix (int32 when
    the doubled-genome coordinate fits)."""
    import numpy as np
    dt = np.int32 if 2 * l_pac < 2**31 - 2 else np.int64
    return np.stack([np.asarray(a).astype(dt) for a in
                     (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w)],
                    axis=1)


@functools.partial(jax.jit, static_argnames=("Lq", "Lt"))
def build_qt(reads: jnp.ndarray, pac_words: jnp.ndarray, l_pac,
             desc: jnp.ndarray, Lq: int, Lt: int):
    """Reconstruct a wave's (q, t) int32 tiles on device from the packed
    descriptor matrix (reg2aln and any kernel that takes materialized
    q/t)."""
    q = gather_reads(reads, desc[:, D_RID], desc[:, D_QS], desc[:, D_QD],
                     Lq)
    t = fetch_fmd_batch(pac_words, l_pac, desc[:, D_TS], desc[:, D_TD], Lt)
    return q, t


@functools.partial(jax.jit, static_argnames=("Lq", "Lt", "opt_key"))
def extend_wave_resident(reads: jnp.ndarray, pac_words: jnp.ndarray, l_pac,
                         desc: jnp.ndarray, mat, Lq: int, Lt: int,
                         opt_key: tuple):
    """One extend wave fed from resident data: gather + banded extend,
    single fused jit, one packed descriptor upload and one packed (6, B)
    download. ``opt_key`` = (o_del, e_del, o_ins, e_ins, end_bonus,
    zdrop)."""
    from .sw_batch import extend_batch
    o_del, e_del, o_ins, e_ins, end_bonus, zdrop = opt_key
    q = gather_reads(reads, desc[:, D_RID], desc[:, D_QS], desc[:, D_QD],
                     Lq)
    t = fetch_fmd_batch(pac_words, l_pac, desc[:, D_TS], desc[:, D_TD], Lt)
    qlen = desc[:, D_QL].astype(jnp.int32)
    tlen = desc[:, D_TL].astype(jnp.int32)
    h0 = desc[:, D_H0].astype(jnp.int32)
    w = desc[:, D_W].astype(jnp.int32)
    return extend_batch(
        q, qlen, t, tlen, mat, w, h0, o_del=o_del, e_del=e_del,
        o_ins=o_ins, e_ins=e_ins, end_bonus=end_bonus, zdrop=zdrop,
        packed=True)
