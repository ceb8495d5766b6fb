"""Batched banded global alignment (ksw_global2) on device, with traceback.

``global_batch`` computes scores and band-packed direction bytes (one byte
per in-band cell) for a whole wave. Same vectorization structure as
sw_batch: rows sequential, columns elementwise + one prefix-max scan for F
(gap opens come from the diagonal M).

The CIGAR walk runs on the device too (``traceback_ops_device``): only the
per-step op stream and the final cursors come back, bit-packed into one
buffer per wave (``traceback_ops_fused``), and the native RLE finisher
(``cigars_from_ops_packed``) turns them into CIGARs. ``traceback`` is the
per-task host walk over downloaded bytes that the tests hold the device
walk to; on an H100 the device walk beat downloading z and walking it in
C++ at the 151 bp reg2aln wave shape (PERF.md).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -0x40000000


class GlobalBatchResult(NamedTuple):
    score: jnp.ndarray   # (B,)
    z: jnp.ndarray       # (B, Lt, n_col) uint8 direction bytes
    beg: jnp.ndarray     # (B, Lt) band start per row (for traceback decode)


@functools.partial(jax.jit, static_argnames=("o_del", "e_del", "o_ins", "e_ins",
                                             "n_col"))
def global_batch(query: jnp.ndarray, qlen: jnp.ndarray,
                 target: jnp.ndarray, tlen: jnp.ndarray,
                 mat: jnp.ndarray, w: jnp.ndarray, n_col: int,
                 o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                 e_ins: int = 1) -> GlobalBatchResult:
    """Banded global DP for a batch of tasks; per-task band width w.

    n_col must be >= max(min(qlen_i, 2*w_i+1)); direction bytes for row i are
    stored at columns [0, end_i-beg_i).
    """
    B, Lq = query.shape
    Lt = target.shape[1]
    query = query.astype(jnp.int32)
    target = target.astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    w = w.astype(jnp.int32)
    mat = mat.astype(jnp.int32)
    gapoe_del = o_del + e_del
    gapoe_ins = o_ins + e_ins

    jidx = jnp.arange(Lq + 1, dtype=jnp.int32)[None, :]
    jr = jnp.arange(Lq, dtype=jnp.int32)[None, :]

    # first row: eh_h[0]=0; eh_h[j] = -(o_ins + e_ins*j) for 1<=j<=min(qlen,w)
    row0 = jnp.where(
        (jidx >= 1) & (jidx <= jnp.minimum(qlen, w)[:, None]),
        -(o_ins + e_ins * jidx), NEG)
    row0 = jnp.where(jidx == 0, 0, row0)
    eh_h0 = row0.astype(jnp.int32)
    eh_e0 = jnp.full((B, Lq + 1), NEG, jnp.int32)

    qsub = mat[:, query.reshape(-1)].reshape(5, B, Lq)

    class _S(NamedTuple):
        eh_h: jnp.ndarray
        eh_e: jnp.ndarray
        z: jnp.ndarray
        begs: jnp.ndarray

    init = _S(eh_h0, eh_e0,
              jnp.zeros((B, Lt, n_col), jnp.uint8),
              jnp.zeros((B, Lt), jnp.int32))

    def row_step(i, s: _S) -> _S:
        i32 = jnp.int32(i)
        in_row = i32 < tlen
        beg = jnp.maximum(i32 - w, 0)
        end = jnp.minimum(i32 + w + 1, qlen)
        band = (jr >= beg[:, None]) & (jr < end[:, None])
        h1_init = jnp.where(beg == 0, -(o_del + e_del * (i32 + 1)), NEG)
        tcode = target[:, jnp.minimum(i32, Lt - 1)]
        sub = jnp.take_along_axis(
            qsub, tcode[None, :, None].astype(jnp.int32), axis=0)[0]
        M = s.eh_h[:, :Lq] + sub
        E = s.eh_e[:, :Lq]
        # F scan (no zero floor; NEG flows)
        a = jnp.where(band, (M - gapoe_ins) + jr * e_ins, NEG)
        run = jax.lax.associative_scan(jnp.maximum, a, axis=1)
        F = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32),
             run[:, :-1] - jr[:, :-1] * e_ins], axis=1)
        F = jnp.where(jr == beg[:, None], NEG, F)
        # bwa-exact: f starts at the FINITE NEG sentinel at band start and
        # decays by e_ins per column; the decayed sentinel can win the strict
        # f>t comparison at the left band edge (flips F-extend bits there)
        F = jnp.maximum(F, NEG - (jr - beg[:, None]) * e_ins)
        d = jnp.where(M >= E, 0, 1).astype(jnp.uint8)
        h = jnp.maximum(M, E)
        d = jnp.where(h >= F, d, jnp.uint8(2))
        h = jnp.maximum(h, F)
        e_ext = E - e_del
        e_open = M - gapoe_del
        d = d | ((e_ext > e_open).astype(jnp.uint8) << 2)
        f_ext = F - e_ins
        f_open = M - gapoe_ins
        # F-extend marker is VALUE 2 at bits 4-5 (C: d |= 2<<4)
        d = d | ((f_ext > f_open).astype(jnp.uint8) << 5)
        d = jnp.where(band, d, jnp.uint8(0))
        # pack the band columns [beg, end) into z[:, i, 0:end-beg] via gather
        cidx = beg[:, None] + jnp.arange(n_col, dtype=jnp.int32)[None, :]
        zrow = jnp.take_along_axis(
            jnp.concatenate([d, jnp.zeros((B, 1), jnp.uint8)], axis=1),
            jnp.clip(cidx, 0, Lq), axis=1)
        zrow = jnp.where(cidx < end[:, None], zrow, jnp.uint8(0))
        # write-back
        h_shift = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), h], axis=1)
        wmask = (jidx > beg[:, None]) & (jidx <= end[:, None])
        eh_h = jnp.where(wmask, h_shift, s.eh_h)
        eh_h = jnp.where(jidx == beg[:, None], h1_init[:, None], eh_h)
        e_new = jnp.maximum(e_ext, e_open)
        e_pad = jnp.concatenate([e_new, jnp.full((B, 1), NEG, jnp.int32)],
                                axis=1)
        emask = (jidx >= beg[:, None]) & (jidx < end[:, None])
        eh_e = jnp.where(emask, e_pad, s.eh_e)
        eh_e = jnp.where(jidx == end[:, None], NEG, eh_e)
        keep = in_row
        return _S(jnp.where(keep[:, None], eh_h, s.eh_h),
                  jnp.where(keep[:, None], eh_e, s.eh_e),
                  s.z.at[:, i, :].set(jnp.where(keep[:, None], zrow,
                                                s.z[:, i, :])),
                  s.begs.at[:, i].set(jnp.where(keep, beg, 0)))

    final = jax.lax.fori_loop(0, Lt, row_step, init)
    score = jnp.take_along_axis(final.eh_h, qlen[:, None], axis=1)[:, 0]
    return GlobalBatchResult(score=score, z=final.z, beg=final.begs)


# ------------------------------------------------------------ device walk

@functools.partial(jax.jit, static_argnames=("S", "pack"))
def traceback_ops_device(zp: jnp.ndarray, qlen: jnp.ndarray,
                         tlen: jnp.ndarray, w: jnp.ndarray, S: int,
                         pack: bool = False):
    """Walk ``global_batch``'s band-packed direction bytes ON DEVICE.

    The walk is the exact ksw_global2 backtrack (same bit reads as
    ``traceback``), vectorized over tasks with masked lanes; only the
    per-step op stream (B, S) uint8 and the final (i, k) cursors come back
    to the host — ~Lq/2 bytes per task instead of the whole z matrix. Ops
    are emitted in walk (reverse-alignment) order; 255 marks end-of-walk.
    S must be >= Lt + Lq (a step consumes at least one of i/k).
    """
    B, Lt, n_col = zp.shape
    zflat = zp.reshape(B, Lt * n_col).astype(jnp.int32)
    qlen = qlen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    w = w.astype(jnp.int32)
    i0 = tlen - 1
    k0 = jnp.minimum(i0 + w + 1, qlen) - 1

    def step(s, carry):
        i, k, which, buf = carry
        active = (i >= 0) & (k >= 0)
        beg = jnp.maximum(i - w, 0)
        col = jnp.clip(k - beg, 0, n_col - 1)
        row = jnp.clip(i, 0, Lt - 1)
        d = jnp.take_along_axis(zflat, (row * n_col + col)[:, None],
                                axis=1)[:, 0]
        which_new = (d >> (which << 1)) & 3
        op = jnp.where(which_new == 0, 0, jnp.where(which_new == 1, 2, 1))
        di = jnp.where(which_new == 2, 0, 1)   # I consumes no target row
        dk = jnp.where(which_new == 1, 0, 1)   # D consumes no query col
        buf = buf.at[:, s].set(
            jnp.where(active, op, 255).astype(jnp.uint8))
        i = jnp.where(active, i - di, i)
        k = jnp.where(active, k - dk, k)
        which = jnp.where(active, which_new, which)
        return (i, k, which, buf)

    buf0 = jnp.full((B, S), 255, jnp.uint8)
    i, k, which, buf = jax.lax.fori_loop(
        0, S, step, (i0, k0, jnp.zeros_like(i0), buf0))
    if pack:
        # 4 two-bit ops per byte (LSB-first): ops are 0/1/2 and the 255
        # end-marker folds to 3 under & 3
        assert S % 4 == 0, "pack requires S % 4 == 0"
        p = (buf & 3).reshape(B, S // 4, 4).astype(jnp.uint8)
        packed = (p[:, :, 0] | (p[:, :, 1] << 2) | (p[:, :, 2] << 4)
                  | (p[:, :, 3] << 6))
        return packed, i, k
    return buf, i, k


@functools.partial(jax.jit, static_argnames=("S",))
def traceback_ops_fused(zp: jnp.ndarray, qlen: jnp.ndarray, tlen: jnp.ndarray,
                        w: jnp.ndarray, score: jnp.ndarray, S: int):
    """Device traceback + bit-pack + single-buffer marshalling.

    Returns ONE (B, S//4 + 12) uint8 array: the packed op stream followed by
    score, i_fin, k_fin as little-endian int32 bytes, so a reg2aln wave
    costs one device->host transfer."""
    packed, i, k = traceback_ops_device(zp, qlen, tlen, w, S=S, pack=True)

    def b32(x):
        v = x.astype(jnp.int32)[:, None]
        return jax.lax.bitcast_convert_type(v, jnp.uint8).reshape(-1, 4)

    return jnp.concatenate([packed, b32(score), b32(i), b32(k)], axis=1)


def split_traceback_blob(blob: np.ndarray, S: int):
    """Host-side unpack of traceback_ops_fused's buffer."""
    P = S // 4
    packed = blob[:, :P]
    score = np.ascontiguousarray(blob[:, P:P + 4]).view(np.int32).ravel()
    i_fin = np.ascontiguousarray(blob[:, P + 4:P + 8]).view(np.int32).ravel()
    k_fin = np.ascontiguousarray(blob[:, P + 8:P + 12]).view(np.int32).ravel()
    return packed, score, i_fin, k_fin


def _native_finish(symbol: str, ops: np.ndarray, i_fin, k_fin, S: int):
    from ..index.suffix import _load_native
    lib = _load_native()
    if lib is None or not hasattr(lib, symbol):
        return None
    import ctypes
    B = ops.shape[0]
    o = np.ascontiguousarray(ops, dtype=np.uint8)
    iv = np.asarray(i_fin, dtype=np.int32)
    kv = np.asarray(k_fin, dtype=np.int32)
    cap = S + 2
    cig = np.empty((B, 2 * cap), dtype=np.int32)
    nops = np.empty(B, dtype=np.int32)
    i64 = ctypes.c_int64
    getattr(lib, symbol)(
        ctypes.c_void_p(o.ctypes.data), i64(B), i64(S),
        ctypes.c_void_p(iv.ctypes.data), ctypes.c_void_p(kv.ctypes.data),
        ctypes.c_void_p(cig.ctypes.data), i64(cap),
        ctypes.c_void_p(nops.ctypes.data))
    return cig, nops


def cigars_from_ops_raw(ops: np.ndarray, i_fin: np.ndarray,
                        k_fin: np.ndarray):
    """Native RLE finish of the raw (B, S) op stream, returning the
    ((B, 2*cap) int32 matrix, nops) pair that Reg2AlnSession.feed
    consumes. None when the native helper is unavailable."""
    return _native_finish("ksw_cigar_from_ops_batch", ops, i_fin, k_fin,
                          ops.shape[1])


def cigars_from_ops_packed(packed: np.ndarray, i_fin: np.ndarray,
                           k_fin: np.ndarray, S: int):
    """Native RLE finish for the bit-packed (B, S//4) op stream produced by
    ``traceback_ops_device(..., pack=True)``. None without the native lib."""
    return _native_finish("ksw_cigar_from_ops_packed_batch", packed, i_fin,
                          k_fin, S)


def cigars_from_ops(ops: np.ndarray, i_fin: np.ndarray, k_fin: np.ndarray
                    ) -> List[List[Tuple[int, int]]]:
    """Host finish of the device walk: RLE-merge ops + tails, reversed.

    Identical output to ``traceback``; uses the native C++ helper when
    built.
    """
    B, S = ops.shape
    raw = cigars_from_ops_raw(ops, i_fin, k_fin)
    if raw is not None:
        cig, nops = raw
        out = []
        for b in range(B):
            n = int(nops[b])
            flat = cig[b, :2 * n].tolist()
            out.append(list(zip(flat[0::2], flat[1::2])))
        return out
    out = []
    for b in range(B):
        cigar: List[Tuple[int, int]] = []
        for s in range(S):
            v = int(ops[b, s])
            if v == 255:
                break
            _push(cigar, v, 1)
        if int(i_fin[b]) >= 0:
            _push(cigar, 2, int(i_fin[b]) + 1)
        if int(k_fin[b]) >= 0:
            _push(cigar, 1, int(k_fin[b]) + 1)
        cigar.reverse()
        out.append([tuple(c) for c in cigar])
    return out


# -------------------------------------------------------------- host walk

def _push(cigar: List[Tuple[int, int]], op: int, ln: int) -> None:
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + ln)
    else:
        cigar.append((op, ln))


def traceback(z: np.ndarray, begs: np.ndarray, qlen: int, tlen: int,
              w: int) -> List[Tuple[int, int]]:
    """Host CIGAR walk over one task's direction bytes (ksw_global2 backtrack).

    Ops: 0=M, 1=I (query), 2=D (target).
    """
    cigar: List[Tuple[int, int]] = []
    which = 0
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    while i >= 0 and k >= 0:
        beg = int(begs[i])
        which = (int(z[i, k - beg]) >> (which << 1)) & 3
        if which == 0:
            _push(cigar, 0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push(cigar, 2, 1)
            i -= 1
        else:
            _push(cigar, 1, 1)
            k -= 1
    if i >= 0:
        _push(cigar, 2, i + 1)
    if k >= 0:
        _push(cigar, 1, k + 1)
    cigar.reverse()
    return cigar
