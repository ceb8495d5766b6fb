"""Batched FM-index rank queries and bidirectional extension on device.

Device-resident index layout (built once from the host FMIndex):
 - ``bwt_packed``: (n_words,) uint32, 16 2-bit codes per word, base 0 in the
   high bits (same packing as the on-disk format);
 - ``occ_ckpt``: (n_blocks+1, 4) int32 ranks before each 128-base block;
 - L2 (5,), primary, seq_len scalars.

occ4 for a batch of row indices is: one checkpoint gather + an in-block count
over 8 words, evaluated with vectorized popcount-style masking — no data-
dependent shapes, so it jits and shards cleanly. The SMEM state machines in
``smem_batch`` run batch-synchronously with lane masking.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.fmindex import FMIndex, OCC_INTERVAL

WORDS_PER_BLOCK = OCC_INTERVAL // 16  # 8


def _fused_table(fm: FMIndex) -> np.ndarray:
    """(n_blocks+1, 12) uint32 fused occ row: [ckpt 0..3 | 8 bwt words].

    Assembled from ``fm.packed_words`` (block-padded, base 0 in the high
    bits — identical word layout) + ``occ_ckpt``, so at hg38 scale the
    build is a ~3 GB mmap copy instead of the 25 GB unpack-repack temporary
    storm the old path allocated (which starved the host worker pool for
    the length of a run). When the index lives in a ``.lariat.d`` dir the
    result is persisted as ``fused.npy`` (atomic rename) and mmapped on
    every later load — the device upload then streams from page cache.
    Per-code rank checkpoints fit uint32 for any genome (< 4 Gbp per code).
    """
    import os
    import tempfile

    d = getattr(fm, "_dir", None)
    path = os.path.join(d, "fused.npy") if d else None
    if path and os.path.exists(path):
        return np.load(path, mmap_mode="r")
    n = len(fm.bwt_codes)
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    fused = np.zeros((n_blocks + 1, 12), dtype=np.uint32)
    fused[:, :4] = fm.occ_ckpt
    fused[:n_blocks, 4:] = np.asarray(
        fm.packed_words)[:n_blocks * WORDS_PER_BLOCK].reshape(
            n_blocks, WORDS_PER_BLOCK)
    if path:
        try:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, fused)
            os.replace(tmp, path)
        except OSError:
            pass
    return fused


def pac_words_host(fm: FMIndex) -> np.ndarray:
    """(ceil(l_pac/16),) uint32 forward pac, 16 bases/word (byte 0 in the
    high bits). Disk-cached as ``pac_words.npy`` in the index dir like
    ``_fused_table`` — the build reads the 2-bit pac bytes once."""
    import os
    import tempfile

    d = getattr(fm, "_dir", None)
    path = os.path.join(d, "pac_words.npy") if d else None
    if path and os.path.exists(path):
        return np.load(path, mmap_mode="r")
    pac = np.asarray(fm.pac)
    padb = (-len(pac)) % 4
    if padb:
        pac = np.concatenate([pac, np.zeros(padb, np.uint8)])
    words = (pac.reshape(-1, 4).astype(np.uint32)
             << np.array([24, 16, 8, 0], np.uint32)).sum(
                 axis=1, dtype=np.uint32)
    if path:
        try:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, words)
            os.replace(tmp, path)
        except OSError:
            pass
    return words


class DeviceFMIndex(NamedTuple):
    bwt_words: jnp.ndarray   # (n_blocks, 8) uint32 padded to block boundary
    occ_ckpt: jnp.ndarray    # (n_blocks+1, 4) int32
    L2: jnp.ndarray          # (5,) int32/int64
    primary: jnp.ndarray     # () int
    seq_len: jnp.ndarray     # () int
    fused: jnp.ndarray       # (n_blocks+1, 12) uint32: [ckpt 0..3, words 0..7]
    # one row gather serves both the rank base and the in-block popcount
    # (per-code counts fit uint32 for any genome below 4 Gbp x2)

    @classmethod
    def from_host(cls, fm: FMIndex) -> "DeviceFMIndex":
        # genome coordinates fit int32 for anything below ~1 Gbp doubled;
        # int64 only when required
        idx_dtype = np.int32 if fm.seq_len + 2 < 2**31 else np.int64
        # every device rank/code query rides the fused row now; the
        # separate planes would duplicate ~2.3 GB of HBM at hg38 scale
        return cls(
            bwt_words=jnp.zeros((0, WORDS_PER_BLOCK), jnp.uint32),
            occ_ckpt=jnp.zeros((0, 4), idx_dtype),
            L2=jnp.asarray(fm.L2.astype(idx_dtype)),
            primary=jnp.asarray(idx_dtype(fm.primary)),
            seq_len=jnp.asarray(idx_dtype(fm.seq_len)),
            fused=jnp.asarray(_fused_table(fm)))

    @property
    def idx_dtype(self):
        return self.L2.dtype


def _block_counts(words: jnp.ndarray, rem: jnp.ndarray) -> jnp.ndarray:
    """Count codes 0..3 among the first ``rem`` bases of each 8-word block.

    words: (..., 8) uint32; rem: (...,) int32 in [0, 128]. Returns (..., 4)
    int32. Uses the 2-bit-field popcount trick: per word, per code c, a base
    matches iff its 2-bit field XOR c is 00; fields past ``rem`` are forced
    to mismatch by ORing a sentinel.
    """
    word_base = jnp.arange(WORDS_PER_BLOCK, dtype=jnp.int32) * 16
    # number of valid bases within each word: clamp(rem - word_base, 0, 16)
    nvalid = jnp.clip(rem[..., None] - word_base, 0, 16)      # (..., 8)
    # mask of the top 2*nvalid bits (base 0 is in the high bits)
    shift = (32 - 2 * nvalid).astype(jnp.uint32)
    keep = jnp.where(nvalid > 0,
                     (jnp.uint32(0xFFFFFFFF) >> shift) << shift,
                     jnp.uint32(0))
    counts = []
    for c in range(4):
        pat = jnp.uint32(c * 0x55555555)
        y = words ^ pat
        # field == 0 iff both bits zero; indicator lands on the field's low
        # bit (even positions), which ``keep`` covers exactly for valid fields
        m = ~(y | (y >> 1)) & jnp.uint32(0x55555555)
        counts.append(jax.lax.population_count(m & keep))
    out = jnp.stack(counts, axis=-1).astype(jnp.int32)
    return jnp.sum(out, axis=-2)


def occ4_batch(fmd: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched occ4: counts of each code in physical BWT rows [0..k].

    k: (...,) row indices in [-1, seq_len]. Returns (..., 4) in the index
    dtype.
    """
    dt = fmd.idx_dtype
    k = k.astype(dt)
    is_total = k == fmd.seq_len
    is_neg = k < 0
    kk = jnp.where(k >= fmd.primary, k - 1, k)
    kk = jnp.clip(kk, 0, fmd.seq_len - 1)
    blk = (kk + 1) // OCC_INTERVAL
    rem = ((kk + 1) % OCC_INTERVAL).astype(jnp.int32)
    row = fmd.fused[blk]                                 # (..., 12) uint32
    base = row[..., :4].astype(dt)
    words = row[..., 4:]
    inblock = _block_counts(words, rem).astype(dt)
    out = base + inblock
    total = fmd.L2[1:5] - fmd.L2[0:4]
    out = jnp.where(is_total[..., None], total, out)
    out = jnp.where(is_neg[..., None], 0, out)
    return out


def occ4_fused_batch(fmd: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """occ4 with a SINGLE fused-row gather (checkpoint + words in one row).

    Same results as ``occ4_batch`` but touches one (12,) uint32 row per
    lane instead of two separate arrays — the gather is the dominant cost
    of every FM step on device, so halving the gather count matters more
    than the extra uint32->dt converts.
    """
    dt = fmd.idx_dtype
    k = k.astype(dt)
    is_total = k == fmd.seq_len
    is_neg = k < 0
    kk = jnp.where(k >= fmd.primary, k - 1, k)
    kk = jnp.clip(kk, 0, fmd.seq_len - 1)
    blk = (kk + 1) // OCC_INTERVAL
    rem = ((kk + 1) % OCC_INTERVAL).astype(jnp.int32)
    row = fmd.fused[blk]                                 # (..., 12) uint32
    base = row[..., :4].astype(dt)
    words = row[..., 4:]
    inblock = _block_counts(words, rem).astype(dt)
    out = base + inblock
    total = fmd.L2[1:5] - fmd.L2[0:4]
    out = jnp.where(is_total[..., None], total, out)
    out = jnp.where(is_neg[..., None], 0, out)
    return out


def bwt_extend_dir_batch(fmd: DeviceFMIndex, x0: jnp.ndarray,
                         x1: jnp.ndarray, s: jnp.ndarray, c: jnp.ndarray,
                         is_back: jnp.ndarray
                         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-lane-direction bidirectional extension by a known code.

    c: (...,) codes 0..3 (the base being appended/prepended as READ text —
    the forward side extends by the complement internally, matching
    ``bwt_extend_batch(is_back=False)[3 - c]``). is_back: (...,) bool.
    Returns the extended (x0, x1, s) per lane. Two fused occ4 gathers.
    """
    dt = fmd.idx_dtype
    s = s.astype(dt)
    qpos = jnp.where(is_back, x0, x1).astype(dt)
    other_base = jnp.where(is_back, x1, x0).astype(dt)
    ce = jnp.where(is_back, c, 3 - c).astype(jnp.int32)
    tk = occ4_fused_batch(fmd, qpos - 1)
    tl = occ4_fused_batch(fmd, qpos - 1 + s)
    sizes = tl - tk
    starts = fmd.L2[:4][None, :] + 1 + tk
    crosses = ((qpos <= fmd.primary)
               & (qpos + s - 1 >= fmd.primary)).astype(dt)
    # other-side start for code ce: other_base + crosses + sum of sizes of
    # codes > ce (codes enumerated 3,2,1,0 in the cumulative chain)
    o3 = other_base + crosses
    o2 = o3 + sizes[..., 3]
    o1 = o2 + sizes[..., 2]
    o0 = o1 + sizes[..., 1]
    other = jnp.stack([o0, o1, o2, o3], axis=-1)
    cix = ce[..., None]
    st = jnp.take_along_axis(starts, cix, axis=-1)[..., 0]
    ot = jnp.take_along_axis(other, cix, axis=-1)[..., 0]
    ns = jnp.take_along_axis(sizes, cix, axis=-1)[..., 0]
    nx0 = jnp.where(is_back, st, ot)
    nx1 = jnp.where(is_back, ot, st)
    return nx0, nx1, ns


def occ1_batch(fmd: DeviceFMIndex, k: jnp.ndarray, c: jnp.ndarray
               ) -> jnp.ndarray:
    """Batched occ for a single code per lane (cheaper than occ4).

    k: (...,) rows in [-1, seq_len]; c: (...,) codes 0..3.
    """
    dt = fmd.idx_dtype
    k = k.astype(dt)
    is_total = k == fmd.seq_len
    is_neg = k < 0
    kk = jnp.where(k >= fmd.primary, k - 1, k)
    kk = jnp.clip(kk, 0, fmd.seq_len - 1)
    blk = (kk + 1) // OCC_INTERVAL
    rem = ((kk + 1) % OCC_INTERVAL).astype(jnp.int32)
    row = fmd.fused[blk]                                 # (..., 12) uint32
    # rank base: 4-way select on the code (cheaper than any gather)
    base = row[..., 0]
    for cc in range(1, 4):
        base = jnp.where(c == cc, row[..., cc], base)
    base = base.astype(dt)
    words = row[..., 4:]                                 # (..., 8)
    word_base = jnp.arange(WORDS_PER_BLOCK, dtype=jnp.int32) * 16
    nvalid = jnp.clip(rem[..., None] - word_base, 0, 16)
    shift = (32 - 2 * nvalid).astype(jnp.uint32)
    keep = jnp.where(nvalid > 0,
                     (jnp.uint32(0xFFFFFFFF) >> shift) << shift,
                     jnp.uint32(0))
    pat = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    y = words ^ pat
    m = ~(y | (y >> 1)) & jnp.uint32(0x55555555)
    inblock = jnp.sum(jax.lax.population_count(m & keep), axis=-1,
                      dtype=jnp.int32).astype(dt)
    out = base + inblock
    total = jnp.take_along_axis(
        (fmd.L2[1:5] - fmd.L2[0:4])[None, :],
        c.reshape(-1, 1).astype(jnp.int32), axis=-1).reshape(c.shape)
    out = jnp.where(is_total, total, out)
    out = jnp.where(is_neg, 0, out)
    return out


def lf_batch(fmd: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched LF mapping (bwt_invPsi) with a single fused-row gather.

    k must not equal `primary` elementwise (callers mask that case to 0).
    For k != primary the code row index and the rank position share the same
    block: kx = k - (k > primary); LF(k) = L2[c] + ckpt[blk][c] +
    count(c in first kx%128+1 bases of block kx//128).
    """
    dt = fmd.idx_dtype
    k = k.astype(dt)
    kx = jnp.where(k > fmd.primary, k - 1, k)
    blk = kx // OCC_INTERVAL
    pos = (kx % OCC_INTERVAL).astype(jnp.int32)       # in-block code position
    row = fmd.fused[blk]                              # (..., 12)
    words = row[..., 4:]
    widx = pos // 16
    word = jnp.take_along_axis(words, widx[..., None].astype(jnp.int32),
                               axis=-1)[..., 0]
    c = ((word >> ((15 - (pos % 16)).astype(jnp.uint32) * 2)) & 3)
    c = c.astype(jnp.int32)
    base = row[..., 0]
    for cc in range(1, 4):
        base = jnp.where(c == cc, row[..., cc], base)
    # count of c among the first pos+1 bases of the block
    rem = pos + 1
    word_base = jnp.arange(WORDS_PER_BLOCK, dtype=jnp.int32) * 16
    nvalid = jnp.clip(rem[..., None] - word_base, 0, 16)
    shift = (32 - 2 * nvalid).astype(jnp.uint32)
    keep = jnp.where(nvalid > 0,
                     (jnp.uint32(0xFFFFFFFF) >> shift) << shift,
                     jnp.uint32(0))
    pat = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[..., None]
    y = words ^ pat
    m = ~(y | (y >> 1)) & jnp.uint32(0x55555555)
    inblock = jnp.sum(jax.lax.population_count(m & keep), axis=-1,
                      dtype=jnp.int32)
    return fmd.L2[c] + base.astype(dt) + inblock.astype(dt)


def backward_ext_batch(fmd: DeviceFMIndex, k: jnp.ndarray, l: jnp.ndarray,
                       c: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched backward search step on [k, l] inclusive intervals.

    k, l, c: (...,) arrays; c int codes 0..3. Uses single-code ranks (the
    extension code is known per lane, so occ4 would waste 4x the block
    counting).
    """
    l2c = fmd.L2[c]
    nk = l2c + occ1_batch(fmd, k - 1, c) + 1
    nl = l2c + occ1_batch(fmd, l, c)
    return nk, nl


def bwt_extend_batch(fmd: DeviceFMIndex, x0: jnp.ndarray, x1: jnp.ndarray,
                     s: jnp.ndarray, is_back: bool
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched bidirectional extension: intervals for all four codes.

    Returns (ok0, ok1, oks) each of shape (..., 4) — indexed by the
    rank-query base, like the host ``seeding.bwt_extend``.
    """
    dt = fmd.idx_dtype
    qpos = (x0 if is_back else x1).astype(dt)
    s = s.astype(dt)
    tk = occ4_batch(fmd, qpos - 1)
    tl = occ4_batch(fmd, qpos - 1 + s)
    sizes = tl - tk
    starts = fmd.L2[:4][None, :] + 1 + tk
    crosses = ((qpos <= fmd.primary)
               & (qpos + s - 1 >= fmd.primary)).astype(dt)
    other_base = (x1 if is_back else x0).astype(dt)
    o3 = other_base + crosses
    o2 = o3 + sizes[..., 3]
    o1 = o2 + sizes[..., 2]
    o0 = o1 + sizes[..., 1]
    other = jnp.stack([o0, o1, o2, o3], axis=-1)
    if is_back:
        return starts, other, sizes
    return other, starts, sizes


@functools.partial(jax.jit, static_argnames=())
def exact_match_batch(fmd: DeviceFMIndex, reads: jnp.ndarray,
                      lens: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched full-read exact-match backward search.

    reads: (B, L) codes (0..4); lens: (B,). Returns (k, l) inclusive
    intervals (empty when k > l).
    """
    B, L = reads.shape
    dt = fmd.idx_dtype
    k0 = jnp.zeros((B,), dt)
    l0 = jnp.full((B,), fmd.seq_len, dtype=dt)

    def step(t, kl):
        k, l = kl
        # process base at position len-1-t for each read
        idx = jnp.clip(lens - 1 - t, 0, L - 1)
        c = jnp.take_along_axis(reads, idx[:, None].astype(jnp.int32),
                                axis=1)[:, 0].astype(jnp.int32)
        active = (t < lens) & (k <= l) & (c < 4)
        nk, nl = backward_ext_batch(fmd, k, l, jnp.clip(c, 0, 3))
        ambiguous = (t < lens) & (c >= 4)
        k = jnp.where(active, nk, k)
        l = jnp.where(active, nl, jnp.where(ambiguous, k - 1, l))
        return (k, l)

    k, l = jax.lax.fori_loop(0, L, step, (k0, l0))
    return k, l
