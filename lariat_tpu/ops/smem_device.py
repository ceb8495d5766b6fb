"""Batch-synchronous 3-round SMEM enumeration on device (VERDICT r2 #3).

Reference semantics: native/seed.cpp collect_intv (bwa mem_collect_intv) —
round 1: all SMEMs with len >= min_seed_len; round 2: re-seed long low-occ
SMEMs from their midpoint with min_intv = s + 1; round 3: LAST-like
forward-greedy seeds (bwt_seed_strategy1); then a stable (qb, qe) sort.

Device mapping (a batch-synchronous design, not a port of the scan loop):

 - bwa's smem1a walks scan positions sequentially, each scan doing a
   forward pass then a backward contraction over a variable-length interval
   list — irregular control flow a chip can't batch. Instead we compute,
   for EVERY end position e of every read in the batch, the minimal start
   b(e) such that q[b..e) occurs (with interval size >= min_intv), by
   per-lane backward FM extension with divergence masking: lanes are
   (read, e) pairs, each device step extends every live lane by one base
   (two occ4 block gathers per lane). b(.) is non-decreasing, and
   [b(e), e) is an SMEM exactly when b(e+1) > b(e) — a right-maximality
   proof via occurrence counting shows this reproduces the scan-based
   enumeration set exactly (see docstring of smems_from_starts).
 - round 2 reuses the same kernel with per-lane min_intv = s + 1 and a
   covering-midpoint filter.
 - round 3 is a per-read forward walker (one lane per read).

Host assembly derives the (qb, qe, x0, x1, s) lists from the downloaded
arrays with numpy; order matches collect_intv byte-for-byte (rounds
concatenated then the same stable sort). Parity vs the native C++ is
asserted by tests/test_smem_device.py on fuzz corpora.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .fm_batch import (DeviceFMIndex, bwt_extend_batch,
                       bwt_extend_dir_batch)

import os as _os
import time as _time

SEED_TRACE = _os.environ.get("LARIAT_SEED_TRACE") == "1"
# transitions per while iteration in min_starts_twoptr (see body_u); the
# one-hot emission accumulates scale with the unroll, which offsets the
# saved cond/carry overhead.
UNROLL = int(_os.environ.get("LARIAT_SMEM_UNROLL", "2"))
if UNROLL < 1:
    raise ValueError(f"LARIAT_SMEM_UNROLL must be >= 1, got {UNROLL}")


def _strace(tag, t0):
    if SEED_TRACE:
        print(f"[seedtrace] {tag:14s} {(_time.time()-t0)*1e3:7.1f}ms",
              flush=True)
    return _time.time()


@functools.partial(jax.jit, static_argnames=("L",))
def min_starts_kernel(fmd: DeviceFMIndex, reads: jnp.ndarray,
                      read_idx: jnp.ndarray, e: jnp.ndarray,
                      min_intv: jnp.ndarray, L: int):
    """Per-lane minimal backward extension.

    reads: (R, L) codes 0..4. Lanes i: end position e[i] (exclusive) in
    read read_idx[i]. Returns (b, x0, x1, s, valid): b[i] = minimal start
    such that q[b..e) has interval size >= min_intv[i] (stepping only over
    non-N bases); the bi-interval is the final accepted state. valid=False
    when q[e-1] is N / e out of range (lane contributes nothing).
    """
    dt = fmd.idx_dtype
    flat = reads.reshape(-1)
    e = e.astype(jnp.int32)
    min_intv = jnp.maximum(min_intv.astype(dt), 1)

    def base_at(pos):
        idx = read_idx.astype(jnp.int32) * L + jnp.clip(pos, 0, L - 1)
        return jnp.take(flat, idx).astype(jnp.int32)

    c0 = base_at(e - 1)
    valid = (e >= 1) & (c0 < 4)
    c0c = jnp.clip(c0, 0, 3)
    x0 = fmd.L2[c0c] + 1
    x1 = fmd.L2[3 - c0c] + 1
    s = fmd.L2[c0c + 1] - fmd.L2[c0c]
    b = jnp.where(valid, e - 1, e).astype(jnp.int32)

    def step(t, carry):
        x0, x1, s, b, alive = carry
        pos = e - 2 - t
        c = base_at(pos)
        can = alive & (pos >= 0) & (c < 4)
        ok0, ok1, oks = bwt_extend_batch(
            fmd, jnp.where(can, x0, 1), jnp.where(can, x1, 1),
            jnp.where(can, s, 0), is_back=True)
        cc = jnp.clip(c, 0, 3)[:, None].astype(jnp.int32)
        n0 = jnp.take_along_axis(ok0, cc, axis=1)[:, 0]
        n1 = jnp.take_along_axis(ok1, cc, axis=1)[:, 0]
        ns = jnp.take_along_axis(oks, cc, axis=1)[:, 0]
        acc = can & (ns >= min_intv)
        x0 = jnp.where(acc, n0, x0)
        x1 = jnp.where(acc, n1, x1)
        s = jnp.where(acc, ns, s)
        b = jnp.where(acc, pos, b)
        return (x0, x1, s, b, acc)

    x0, x1, s, b, _ = jax.lax.fori_loop(
        0, L - 1, step, (x0, x1, s, jnp.where(valid, b, e), valid))
    return b, x0, x1, s, valid


@functools.partial(jax.jit, static_argnames=("L", "max_steps", "bwd_init",
                                             "emit_direct", "min_seed",
                                             "cap"))
def min_starts_twoptr(fmd: DeviceFMIndex, reads: jnp.ndarray,
                      start_e: jnp.ndarray, end_e: jnp.ndarray,
                      min_intv: jnp.ndarray, L: int,
                      max_steps: int = 0, bwd_init: bool = False,
                      emit_direct: bool = False, min_seed: int = 0,
                      cap: int = 0, mid=None):
    """Two-pointer minimal-starts machine: same per-end function as
    ``min_starts_kernel`` but with O(total match length) extensions per
    lane instead of O(L) per (lane, e) pair — ~L x fewer rank queries.

    Lanes are READS (or reseed requests), not (read, e) pairs. Per lane:
    outputs b(e), x0(e), x1(e), s(e), valid(e) for every end position
    e in (start_e, end_e], where b(e) is the greedy backward stop from e
    under ``min_intv`` (identical to min_starts_kernel's definition).

    Why incremental is exact: if [b(e), e+1) still has s >= min_intv then
    the greedy backward scan from e+1 passes through every x in
    (b(e), e+1) (substring monotonicity) and fails at b(e)-1 for the same
    reason it failed for e (s is non-increasing under left extension), so
    b(e+1) == b(e) and one FORWARD extension advances the machine. On
    failure, b(e+1) is re-derived by a fresh greedy BACKWARD scan from
    e+1, which by the same argument stops at some b' > b(e). Total rank
    queries = forward accepts + backward scan lengths ~ O(match length).

    Returns (b, x0, x1, s, valid, done_all): arrays (R, L) indexed by
    e-1, plus a scalar "every lane finished within max_steps" flag
    (callers fall back to the quadratic kernel on overflow — only
    adversarial low-complexity reads can get near the cap).

    Reference semantics: native/seed.cpp collect_intv round 1/2
    (bwa mem_collect_intv); see smems_from_starts for the emission rule.
    """
    dt = fmd.idx_dtype
    R = reads.shape[0]
    if not max_steps:
        max_steps = 8 * L
    start_e = start_e.astype(jnp.int32)
    end_e = end_e.astype(jnp.int32)
    min_intv = jnp.maximum(min_intv.astype(dt), 1)
    lane = jnp.arange(R, dtype=jnp.int32)

    def base_at(pos):
        # (R,) codes at q[lane, pos], 4 when out of range
        inb = (pos >= 0) & (pos < L)
        idx = jnp.clip(pos, 0, L - 1)
        return jnp.where(
            inb, jnp.take_along_axis(
                reads, idx[:, None].astype(jnp.int32),
                axis=1)[:, 0].astype(jnp.int32), 4)

    def single_char(c):
        cc = jnp.clip(c, 0, 3)
        return (fmd.L2[cc] + 1, fmd.L2[3 - cc] + 1,
                fmd.L2[cc + 1] - fmd.L2[cc])

    zero_dt = jnp.zeros(R, dt)
    if bwd_init:
        # round-2 reseeds: there is no barrier at start_e, so b(start_e+1)
        # must be derived by a fresh greedy backward scan from start_e+1.
        # N at q[start_e] -> out[start_e+1] stays invalid (never written)
        # and the machine resumes empty at e = start_e + 1.
        c0 = jnp.take_along_axis(
            reads, jnp.clip(start_e, 0, L - 1)[:, None].astype(jnp.int32),
            axis=1)[:, 0].astype(jnp.int32)
        is_n0 = c0 >= 4
        cc0 = jnp.clip(c0, 0, 3)
        state = dict(
            e=jnp.where(is_n0, start_e + 1, start_e),
            b=jnp.where(is_n0, start_e + 1, start_e),
            x0=zero_dt + 1, x1=zero_dt + 1, s=zero_dt,
            bwd=~is_n0, p=start_e, etgt=start_e + 1,
            bx0=jnp.where(is_n0, 1, fmd.L2[cc0] + 1),
            bx1=jnp.where(is_n0, 1, fmd.L2[3 - cc0] + 1),
            bs=jnp.where(is_n0, 0, fmd.L2[cc0 + 1] - fmd.L2[cc0]),
            steps=jnp.int32(0))
    else:
        state = dict(
            e=start_e, b=start_e,
            x0=zero_dt + 1, x1=zero_dt + 1, s=zero_dt,  # interval of [b, e)
            bwd=jnp.zeros(R, jnp.bool_), p=jnp.zeros(R, jnp.int32),
            etgt=jnp.zeros(R, jnp.int32),
            # BWD scratch interval of [p, etgt)
            bx0=zero_dt + 1, bx1=zero_dt + 1, bs=zero_dt,
            steps=jnp.int32(0))

    if emit_direct:
        # plateau-end emission straight into compact slots: no (R, L)
        # planes, no separate compaction pass, tiny while-loop carry.
        # Dense one-hot accumulates instead of scatters. Split into an
        # int32 (qb<<16|qe) plane and a dt (x0, x1, s) plane so the
        # download is 2.5x smaller than all-int64.
        state.update(
            oaccs=jnp.zeros((R, cap), jnp.int32),
            oaccb=jnp.zeros((R, cap, 3), dt),
            n=jnp.zeros(R, jnp.int32))
        mid_a = mid.astype(jnp.int32)
    else:
        state.update(
            ob=jnp.zeros((R, L), jnp.int32),
            ox0=jnp.zeros((R, L), dt), ox1=jnp.zeros((R, L), dt),
            os=jnp.zeros((R, L), dt),
            oval=jnp.zeros((R, L), jnp.bool_))

    def cond(st):
        live = (jnp.where(st["bwd"], st["etgt"], st["e"] + 1)
                <= end_e)
        return jnp.any(live) & (st["steps"] < max_steps)

    def body(st):
        e, b = st["e"], st["b"]
        x0, x1, s = st["x0"], st["x1"], st["s"]
        bwd, p, etgt = st["bwd"], st["p"], st["etgt"]
        bx0, bx1, bs = st["bx0"], st["bx1"], st["bs"]
        fwd_live = (~bwd) & (e + 1 <= end_e)
        bwd_live = bwd & (etgt <= end_e)

        # one (R, 2) gather for both read positions (two separate
        # take_along_axis calls cost a full extra gather pass)
        pos2 = jnp.stack([e, p - 1], axis=1)
        inb2 = (pos2 >= 0) & (pos2 < L)
        c2 = jnp.where(
            inb2, jnp.take_along_axis(
                reads, jnp.clip(pos2, 0, L - 1).astype(jnp.int32),
                axis=1).astype(jnp.int32), 4)
        c_f = c2[:, 0]
        c_b = c2[:, 1]
        empty = fwd_live & (b == e)
        nf = c_f >= 4

        # --- rank lanes: FWD-nonempty non-N forward ext, or BWD prepend
        bwd_free = bwd_live & ((p <= 0) | (c_b >= 4))
        do_bwd = bwd_live & ~bwd_free
        do_fwd = fwd_live & ~empty & ~nf
        need = do_bwd | do_fwd
        rx0 = jnp.where(do_bwd, bx0, x0)
        rx1 = jnp.where(do_bwd, bx1, x1)
        rs = jnp.where(need, jnp.where(do_bwd, bs, s), 0)
        rc = jnp.clip(jnp.where(do_bwd, c_b, c_f), 0, 3)
        nx0, nx1, ns = bwt_extend_dir_batch(
            fmd, jnp.where(need, rx0, 1), jnp.where(need, rx1, 1),
            rs, rc, do_bwd)
        acc = need & (ns >= min_intv)

        # --- transition: FWD empty ---------------------------------------
        sc0, sc1, scs = single_char(c_f)
        # empty & N: out[e+1] invalid; advance, stay empty
        # empty & ~N: out[e+1] = (b=e, single)
        # --- transition: FWD nonempty ------------------------------------
        # nf: out[e+1] invalid; b=e+1; e+=1; empty (free)
        # acc: out[e+1] = (b, I'); e+=1
        # ~acc: enter BWD: etgt=e+1, p=e, scratch=single(c_f)
        # --- transition: BWD ----------------------------------------------
        # bwd_free or ~acc: exit: b=p, e=etgt, I=scratch, out[etgt]=(p, I)
        # acc: p-=1, scratch=I'
        fwd_emit = fwd_live & (empty | nf | acc)
        bwd_exit = bwd_free | (do_bwd & ~acc)
        emit = fwd_emit | bwd_exit
        col = jnp.where(bwd_exit, etgt, e + 1) - 1
        emit_valid = ~(fwd_live & nf)
        emit_b = jnp.where(bwd_exit, p, b)
        emit_x0 = jnp.where(bwd_exit, bx0, jnp.where(empty, sc0, nx0))
        emit_x1 = jnp.where(bwd_exit, bx1, jnp.where(empty, sc1, nx1))
        emit_s = jnp.where(bwd_exit, bs, jnp.where(empty, scs, ns))

        n_e = jnp.where(fwd_emit, e + 1, jnp.where(bwd_exit, etgt, e))
        n_b = jnp.where(fwd_live & nf, e + 1,
                        jnp.where(bwd_exit, p, b))
        n_x0 = jnp.where(bwd_exit, bx0,
                         jnp.where(empty & ~nf, sc0,
                                   jnp.where(do_fwd & acc, nx0, x0)))
        n_x1 = jnp.where(bwd_exit, bx1,
                         jnp.where(empty & ~nf, sc1,
                                   jnp.where(do_fwd & acc, nx1, x1)))
        n_s = jnp.where(bwd_exit, bs,
                        jnp.where(fwd_live & nf, 0,
                                  jnp.where(empty, scs,
                                            jnp.where(do_fwd & acc, ns,
                                                      s))))
        n_s = jnp.where(empty & nf, 0, n_s)
        enter_bwd = do_fwd & ~acc
        n_bwd = jnp.where(bwd_exit, False, bwd | enter_bwd)
        n_p = jnp.where(enter_bwd, e, jnp.where(do_bwd & acc, p - 1, p))
        n_etgt = jnp.where(enter_bwd, e + 1, etgt)
        n_bx0 = jnp.where(enter_bwd, sc0, jnp.where(do_bwd & acc, nx0, bx0))
        n_bx1 = jnp.where(enter_bwd, sc1, jnp.where(do_bwd & acc, nx1, bx1))
        n_bs = jnp.where(enter_bwd, scs, jnp.where(do_bwd & acc, ns, bs))

        if emit_direct:
            # midpoint pruning: b(e) is non-decreasing and every kept seed
            # needs b <= mid, so a FWD-state lane whose b passed mid can
            # never emit again — finish it. Round 2 lanes with min_intv
            # near 1 otherwise pay a full backward rescan per position
            # PAST the midpoint (measured: median r2 lane ~900 steps, ~10x
            # the useful work). Round 1 passes mid = L + 2: never fires.
            dead = (~n_bwd) & (n_b > mid_a)
            n_e = jnp.where(dead, end_e + 1, n_e)

        out = dict(e=n_e, b=n_b, x0=n_x0, x1=n_x1, s=n_s, bwd=n_bwd,
                   p=n_p, etgt=n_etgt, bx0=n_bx0, bx1=n_bx1, bs=n_bs,
                   steps=st["steps"] + 1)
        if emit_direct:
            # a plateau ends when FWD fails (enter_bwd), an N breaks it,
            # or the lane reaches end_e; emission there == the per-e rule
            # (bnext > b fires exactly at the last e of each b-plateau)
            em1 = (enter_bwd | (fwd_live & nf)) & (b < e)
            adv = fwd_emit | bwd_exit
            em2 = adv & (n_e == end_e) & (n_b < n_e)
            seed = em1 | em2                  # mutually exclusive
            sqb = jnp.where(em2, n_b, b)
            sqe = jnp.where(em2, n_e, e)
            keep = (seed & ((sqe - sqb) >= min_seed) & (sqb <= mid_a)
                    & (sqe > start_e))
            n = st["n"]
            sx0 = jnp.where(em2, n_x0, x0)
            sx1 = jnp.where(em2, n_x1, x1)
            ss = jnp.where(em2, n_s, s)
            # dense one-hot accumulate: each (lane, slot) is written at
            # most once over the whole run (n increments with keep)
            oh = (jnp.arange(cap, dtype=jnp.int32)[None, :]
                  == jnp.where(keep, n, -1)[:, None])       # (R, cap)
            qbqe = ((sqb.astype(jnp.int32) << 16)
                    | sqe.astype(jnp.int32))                # L <= 512
            out["oaccs"] = st["oaccs"] + jnp.where(oh, qbqe[:, None], 0)
            upd = jnp.stack([sx0, sx1, ss], axis=-1)        # (R, 3)
            out["oaccb"] = st["oaccb"] + jnp.where(
                oh[:, :, None], upd[:, None, :], 0)
            out["n"] = n + keep.astype(jnp.int32)
        else:
            # non-emitting lanes write to column L (mode="drop" discards)
            colw = jnp.where(emit, col, L)
            out["ob"] = st["ob"].at[lane, colw].set(emit_b, mode="drop")
            out["ox0"] = st["ox0"].at[lane, colw].set(emit_x0, mode="drop")
            out["ox1"] = st["ox1"].at[lane, colw].set(emit_x1, mode="drop")
            out["os"] = st["os"].at[lane, colw].set(emit_s, mode="drop")
            out["oval"] = st["oval"].at[lane, colw].set(emit_valid,
                                                        mode="drop")
        return out

    def body_u(st):
        # UNROLL transitions per while iteration: a finished lane's
        # transition is the identity, so semantics are unchanged while the
        # loop's sequential overhead divides by UNROLL (the cond check +
        # carry shuffle cost as much as a small step body)
        for _ in range(UNROLL):
            st = body(st)
        return st

    st = jax.lax.while_loop(cond, body_u, state)
    live = (jnp.where(st["bwd"], st["etgt"], st["e"] + 1) <= end_e)
    done = ~jnp.any(live)
    if emit_direct:
        # two packed planes (a 2.5x smaller download than one int64 blob):
        #  meta int32 (R, cap+3): [qb<<16|qe slots | count | lane_done |
        #  flags]; big dt (R, 3*cap): [x0 | x1 | s].
        # flags bit 0: all lanes done; bit 1: slot overflow; bits 2+: the
        # while-iteration count (diagnostics — bench/probes read it).
        # lane_done backs the two-phase straggler split: callers rerun
        # just the unfinished lanes with a higher step budget.
        flags = (done.astype(jnp.int32)
                 | (jnp.any(st["n"] > cap).astype(jnp.int32) << 1)
                 | (st["steps"] << 2))
        meta = jnp.concatenate(
            [st["oaccs"],
             jnp.minimum(st["n"], cap)[:, None],
             (~live).astype(jnp.int32)[:, None],
             jnp.zeros((R, 1), jnp.int32) + flags], axis=1)
        big = jnp.transpose(st["oaccb"], (0, 2, 1)).reshape(R, 3 * cap)
        return meta, big
    return (st["ob"], st["ox0"], st["ox1"], st["os"], st["oval"], done)


@functools.partial(jax.jit, static_argnames=("min_seed", "cap"))
def compact_starts(b, x0, x1, s, valid, start_e, end_e, mid, min_seed: int,
                   cap: int):
    """Device-side emission + left-compaction of per-e minimal-starts.

    Applies the SMEM emission rule (right-maximality via b(e+1) > b(e),
    length >= min_seed, e in (start_e, end_e], b <= mid — pass mid >= L
    for round 1 where there is no covering-midpoint constraint) and packs
    the emitted (qb, qe, x0, x1, s) left per lane. Downloading (R, cap)
    instead of five (R, L) planes cuts the per-batch transfer ~8x — the
    download was the next ceiling after the two-pointer kernel.

    Returns (qb, qe, x0, x1, s) as (R, cap) arrays, counts (R,), and a
    scalar overflow flag (any lane emitted > cap; caller falls back to
    the full arrays, which stay as undownloaded device residents).
    """
    R, L = b.shape
    e_mat = jnp.arange(1, L + 1, dtype=jnp.int32)[None, :]
    BIG = jnp.asarray(np.int64(1) << 60, b.dtype) \
        if b.dtype == jnp.int64 else jnp.asarray(np.int32(1) << 30, b.dtype)
    bnext = jnp.concatenate(
        [jnp.where(valid[:, 1:], b[:, 1:], BIG),
         jnp.full((R, 1), BIG, b.dtype)], axis=1)
    emit = (valid
            & (e_mat > start_e[:, None].astype(jnp.int32))
            & (e_mat <= end_e[:, None].astype(jnp.int32))
            & (b.astype(jnp.int64) <= mid[:, None].astype(jnp.int64))
            & ((e_mat.astype(b.dtype) - b) >= min_seed)
            & (bnext > b))
    counts = jnp.sum(emit, axis=1).astype(jnp.int32)
    # stable argsort of ~emit packs emitted columns left, e-ascending
    order = jnp.argsort(~emit, axis=1, stable=True)[:, :cap]

    def take(a):
        return jnp.take_along_axis(a, order, axis=1)

    qb = take(b)
    qe = take(jnp.broadcast_to(e_mat, (R, L)))
    return (qb, qe, take(x0), take(x1), take(s), counts,
            jnp.any(counts > cap))


@functools.partial(jax.jit, static_argnames=("min_seed", "cap"))
def compact_starts_packed(b, x0, x1, s, valid, start_e, end_e, mid, done,
                          min_seed: int, cap: int):
    """compact_starts + everything the host needs in ONE int64 matrix:
    cols [qb*cap | qe*cap | x0*cap | x1*cap | s*cap | count | flags],
    flags = done | overflow<<1 (broadcast). One download per round
    instead of seven."""
    qb, qe, x0c, x1c, sc, counts, ovf = compact_starts(
        b, x0, x1, s, valid, start_e, end_e, mid, min_seed, cap)
    R = b.shape[0]
    flags = (done.astype(jnp.int64)
             | (ovf.astype(jnp.int64) << 1))
    return jnp.concatenate(
        [qb.astype(jnp.int64), qe.astype(jnp.int64), x0c.astype(jnp.int64),
         x1c.astype(jnp.int64), sc.astype(jnp.int64),
         counts.astype(jnp.int64)[:, None],
         jnp.full((R, 1), 0, jnp.int64) + flags], axis=1)


@jax.jit
def _pack_r3(n3, qb3, qe3, ox0, ox1, os3):
    """strategy1 outputs as (meta int32, big dt) — same split as the
    two-pointer machine: qb<<16|qe ride one int32 plane to shrink the
    download."""
    meta = jnp.concatenate(
        [(qb3.astype(jnp.int32) << 16) | qe3.astype(jnp.int32),
         n3.astype(jnp.int32)[:, None]], axis=1)
    big = jnp.concatenate([ox0, ox1, os3], axis=1)
    return meta, big


@functools.partial(jax.jit, static_argnames=("L", "min_len", "cap"))
def strategy1_kernel(fmd: DeviceFMIndex, reads: jnp.ndarray,
                     lens: jnp.ndarray, max_intv, L: int,
                     min_len: int, cap: int):
    """bwt_seed_strategy1 per read: forward-greedy third-round seeds.

    Returns per-read (count, qb[cap], qe[cap], x0[cap], x1[cap], s[cap])
    in emission order (ascending qb — the scan is strictly forward).
    """
    dt = fmd.idx_dtype
    R = reads.shape[0]
    max_intv = jnp.asarray(max_intv, dt)
    lens = lens.astype(jnp.int32)

    def gather(pos):
        return jnp.take_along_axis(
            reads, jnp.clip(pos, 0, L - 1)[:, None].astype(jnp.int32),
            axis=1)[:, 0].astype(jnp.int32)

    # state: x (scan start), interval of q[x..t) (s==0 => needs init)
    init = (jnp.zeros(R, jnp.int32),                      # x
            jnp.ones(R, dt), jnp.ones(R, dt), jnp.zeros(R, dt),  # x0,x1,s
            jnp.zeros(R, jnp.int32),                      # n emitted
            jnp.zeros((R, cap), jnp.int32), jnp.zeros((R, cap), jnp.int32),
            jnp.zeros((R, cap), dt), jnp.zeros((R, cap), dt),
            jnp.zeros((R, cap), dt))

    def step(t, carry):
        x, x0, x1, s, n, qb, qe, ox0, ox1, os_ = carry
        inb = t < lens
        c = gather(jnp.full(R, t, jnp.int32))
        at_start = (t == x) & inb
        is_n = c >= 4
        # N at scan start (or anywhere): restart at t + 1
        cc = jnp.clip(c, 0, 3)
        sx0 = fmd.L2[cc] + 1
        sx1 = fmd.L2[3 - cc] + 1
        ss = fmd.L2[cc + 1] - fmd.L2[cc]
        # forward extension for lanes past their start
        ext = inb & (t > x) & ~is_n
        fc = jnp.clip(3 - c, 0, 3)[:, None].astype(jnp.int32)
        ok0, ok1, oks = bwt_extend_batch(
            fmd, jnp.where(ext, x0, 1), jnp.where(ext, x1, 1),
            jnp.where(ext, s, 0), is_back=False)
        n0 = jnp.take_along_axis(ok0, fc, axis=1)[:, 0]
        n1 = jnp.take_along_axis(ok1, fc, axis=1)[:, 0]
        ns = jnp.take_along_axis(oks, fc, axis=1)[:, 0]
        emit = ext & (ns < max_intv) & ((t - x) >= min_len) & (n < cap)
        # record emitted seed (qb=x, qe=t+1, interval = extended)
        idx = jnp.clip(n, 0, cap - 1)[:, None]
        onehot = (jnp.arange(cap, dtype=jnp.int32)[None, :] == idx)
        w = onehot & emit[:, None]
        qb = jnp.where(w, x[:, None], qb)
        qe = jnp.where(w, t + 1, qe)
        ox0 = jnp.where(w, n0[:, None], ox0)
        ox1 = jnp.where(w, n1[:, None], ox1)
        os_ = jnp.where(w, ns[:, None], os_)
        n = n + emit.astype(jnp.int32)
        # next state
        restart = inb & (is_n | emit)
        x = jnp.where(restart, t + 1, x)
        x0 = jnp.where(at_start & ~is_n, sx0, jnp.where(ext, n0, x0))
        x1 = jnp.where(at_start & ~is_n, sx1, jnp.where(ext, n1, x1))
        s = jnp.where(at_start & ~is_n, ss, jnp.where(ext, ns, s))
        # N at start also restarts
        x = jnp.where(at_start & is_n, t + 1, x)
        return (x, x0, x1, s, n, qb, qe, ox0, ox1, os_)

    out = jax.lax.fori_loop(0, L, step, init)
    x, x0, x1, s, n, qb, qe, ox0, ox1, os_ = out
    return n, qb, qe, ox0, ox1, os_


def smems_from_starts(b: np.ndarray, x0: np.ndarray, x1: np.ndarray,
                      s: np.ndarray, valid: np.ndarray, length: int,
                      min_seed_len: int) -> List[Tuple]:
    """Round-1 SMEM list for ONE read from its per-e arrays (e = 1..L,
    array index e-1).

    [b(e), e) is an SMEM iff it is right-maximal: b(e+1) > b(e), where
    crossing an N or the read end counts as +inf. Proof of equivalence to
    bwa's scan enumeration: every occurrence of [b(e), e) is an occurrence
    of any [x, e) with x >= b(e); if all occurrences of [x, e) extend by
    the same base then so do all occurrences of [b(e), e) — hence
    right-maximality at the scan level and at the b level coincide, and
    b's monotonicity makes each SMEM appear for exactly one e.
    """
    out = []
    for e in range(1, length + 1):
        if not valid[e - 1]:
            continue
        be = int(b[e - 1])
        if e - be < min_seed_len:
            continue
        if e < length and valid[e] and int(b[e]) <= be:
            continue  # extensible to the right: not maximal
        out.append((int(x0[e - 1]), int(x1[e - 1]), int(s[e - 1]),
                    be, e))
    return out


def collect_seeds_arrays_device(fmd: DeviceFMIndex, fm,
                                reads: List[np.ndarray], opt
                                ) -> List[np.ndarray]:
    """Full 3-round collect_intv for a batch of reads: device kernels +
    fully vectorized numpy assembly.

    Returns per-read (n, 5) int64 arrays [x0, x1, s, qb, qe] matching
    native seed.cpp fm_collect_seeds_batch output order bit-for-bit
    (rounds concatenated in emission order, then one stable (qb, qe)
    sort). The host side is pure numpy — no per-seed Python loops (the
    assembly, not the device, was the seeding wall at 8k-read batches).
    """
    n_reads = len(reads)
    if n_reads == 0:
        return []
    R = n_reads
    L = max((len(r) for r in reads), default=1)
    L = max(L, 2)
    # pad shapes to a small fixed set: every distinct (R, L) retraces the
    # lane kernels, and group sizes vary run to run. Padded reads are all-N
    # (every lane invalid -> no seeds), padded lens 0.
    L = -(-L // 64) * 64
    Rp = 128
    while Rp < R:
        Rp <<= 1
    rmat = np.full((Rp, L), 4, np.uint8)
    lens = np.zeros(Rp, np.int32)
    for i, r in enumerate(reads):
        rmat[i, :len(r)] = r
        lens[i] = len(r)
    R = Rp
    rd = jnp.asarray(rmat)
    min_seed = opt.min_seed_len
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)

    _t = _time.time()
    CAP1 = 32

    def _twophase_finish(pk, cap, start_e, end_e, min_intv, mid, bwd_init,
                         full_steps, read_rows=None):
        """Straggler split for the two-pointer machine: the while loop
        bills every lane for the WORST lane's trip count (r2's max lane
        ran 2352 steps while the median needs ~300). Phase A (already dispatched, small
        step budget) resolves typical lanes; the few unfinished lanes are
        rerun from scratch at a narrow width with the full budget and
        their rows spliced in. Returns ((meta, big), flags&3) — flags != 1
        sends the caller down the exhaustive fallback exactly as before."""
        meta = np.asarray(pk[0])
        big = np.asarray(pk[1])
        fl = int(meta[0, -1])
        if (fl & 2) or (fl & 1):
            return (meta, big), fl & 3
        undone = meta[:, cap + 1] == 0
        idx = np.nonzero(undone)[0]
        if SEED_TRACE:
            print(f"[seedtrace] stragglers {len(idx)}/{meta.shape[0]}",
                  flush=True)
        Rs = 128
        while Rs < len(idx):
            Rs <<= 1
        pad = np.zeros(Rs, np.int64)
        sub = {k: pad.copy() for k in ("se", "ee", "mi", "md")}
        sub["mi"] += 1
        sub["se"][:len(idx)] = start_e[idx]
        sub["ee"][:len(idx)] = end_e[idx]
        sub["mi"][:len(idx)] = min_intv[idx]
        sub["md"][:len(idx)] = mid[idx]
        ridx = np.zeros(Rs, np.int64)
        ridx[:len(idx)] = idx
        rows = (read_rows if read_rows is not None else rd)[
            jnp.asarray(ridx)]
        pk2 = min_starts_twoptr(
            fmd, rows, jnp.asarray(sub["se"].astype(np.int32)),
            jnp.asarray(sub["ee"].astype(np.int32)),
            jnp.asarray(sub["mi"]), L, max_steps=full_steps,
            bwd_init=bwd_init, emit_direct=True, min_seed=int(min_seed),
            cap=cap, mid=jnp.asarray(sub["md"].astype(np.int32)))
        meta2 = np.asarray(pk2[0])
        fl2 = int(meta2[0, -1])
        if (fl2 & 2) or not (fl2 & 1):
            return (meta, big), 0  # rare: punt to the exhaustive fallback
        meta = np.array(meta)      # device downloads are read-only views
        big = np.array(big)
        meta[idx] = meta2[:len(idx)]
        big[idx] = np.asarray(pk2[1])[:len(idx)]
        return (meta, big), 1

    # ---- dispatch round 1 + round 3 back to back (async), then download --
    # phase-A step budget: covers the typical lane (fwd pass + rescans of a
    # 151 bp read) with margin; stragglers rerun narrow at 8*L
    r1_steps_a = min(3 * L, 8 * L)
    pk1 = min_starts_twoptr(fmd, rd, jnp.zeros(R, np.int32),
                            jnp.asarray(lens), jnp.ones(R, np.int64), L,
                            max_steps=r1_steps_a,
                            emit_direct=True, min_seed=int(min_seed),
                            cap=CAP1, mid=jnp.full(R, L + 2, np.int32))
    if opt.max_mem_intv > 0:
        cap3 = max(2, L // max(min_seed, 1) + 2)
        r3 = strategy1_kernel(fmd, rd, jnp.asarray(lens),
                              int(opt.max_mem_intv), L, int(min_seed), cap3)
    else:
        r3 = None
    _t = _strace("r1+r3 dispatch", _t)

    def _emit_full(bh, x0h, x1h, sh, vh, start_a, end_a, mid_a):
        """Host emission from full planes (step-cap / overflow fallback)."""
        Rn = bh.shape[0]
        e_mat = np.arange(1, L + 1, dtype=np.int64)[None, :]
        BIG = np.int64(1 << 60)
        bnext = np.full((Rn, L), BIG, np.int64)
        bnext[:, :-1] = np.where(vh[:, 1:], bh[:, 1:].astype(np.int64),
                                 BIG)
        emit = (vh & (e_mat > start_a[:, None]) & (e_mat <= end_a[:, None])
                & (bh.astype(np.int64) <= mid_a[:, None])
                & ((e_mat - bh) >= min_seed) & (bnext > bh))
        ri, ei = np.nonzero(emit)          # lane-major, e-ascending
        m = np.stack([x0h[ri, ei].astype(np.int64),
                      x1h[ri, ei].astype(np.int64),
                      sh[ri, ei].astype(np.int64),
                      bh[ri, ei].astype(np.int64),
                      ei.astype(np.int64) + 1], axis=1)
        return ri, m

    (meta1, big1), flags1 = _twophase_finish(
        pk1, CAP1, np.zeros(R, np.int64), lens.astype(np.int64),
        np.ones(R, np.int64), np.full(R, L + 2, np.int64), False, 8 * L)
    _t = _strace("r1 pack dl", _t)
    if r3 is not None:
        # start round 3's download now so it rides the link while round
        # 2's kernel computes (the downloads are the collect bottleneck)
        pk3 = _pack_r3(*r3)
        try:
            for a in pk3:
                a.copy_to_host_async()
        except Exception:  # noqa: BLE001 - backend without async copy
            pass
    else:
        pk3 = None
    if flags1 != 1:
        # step cap blown or slot overflow (rare): exhaustive per-(read, e)
        # kernel + full-plane host emission (identical function)
        read_idx = np.repeat(np.arange(R, dtype=np.int32), L)
        e_arr = np.tile(np.arange(1, L + 1, dtype=np.int32), R)
        bf_, x0f_, x1f_, sf_, vf_ = min_starts_kernel(
            fmd, rd, jnp.asarray(read_idx), jnp.asarray(e_arr),
            jnp.ones(R * L, np.int64), L)
        bh = np.asarray(bf_).reshape(R, L)
        x0h = np.asarray(x0f_).reshape(R, L)
        x1h = np.asarray(x1f_).reshape(R, L)
        sh = np.asarray(sf_).reshape(R, L)
        vh = np.asarray(vf_).reshape(R, L) & (
            np.arange(1, L + 1, dtype=np.int32)[None] <= lens[:, None])
        ri1, m1 = _emit_full(bh, x0h, x1h, sh, vh,
                             np.zeros(R, np.int64),
                             lens.astype(np.int64),
                             np.full(R, L + 2, np.int64))
    else:
        cnt1 = meta1[:, CAP1]
        kmask = np.arange(CAP1, dtype=np.int32)[None, :] < cnt1[:, None]
        ri1, ki1 = np.nonzero(kmask)       # read-major, e-ascending
        qbqe = meta1[:, :CAP1][ri1, ki1].astype(np.int64)
        qb1 = qbqe >> 16
        qe1 = qbqe & 0xFFFF
        m1 = np.stack([big1[:, 0 * CAP1:1 * CAP1][ri1, ki1].astype(np.int64),
                       big1[:, 1 * CAP1:2 * CAP1][ri1, ki1].astype(np.int64),
                       big1[:, 2 * CAP1:3 * CAP1][ri1, ki1].astype(np.int64),
                       qb1, qe1], axis=1)
    qb1 = m1[:, 3]
    qe1 = m1[:, 4]

    _t = _strace("r1 assembly", _t)
    # ---- round 2: one two-pointer lane per reseed request ----------------
    re_mask = ((qe1 - qb1 >= split_len) & (m1[:, 2] <= opt.split_width))
    r2_reads = ri1[re_mask].astype(np.int32)
    r2_mid = ((qb1[re_mask] + qe1[re_mask]) >> 1).astype(np.int32)
    r2_min = (m1[re_mask, 2] + 1).astype(np.int64)
    n_r2 = len(r2_reads)
    if n_r2:
        R2 = 128
        while R2 < n_r2:
            R2 <<= 1
        r2_read = np.zeros(R2, np.int32)
        r2_start = np.zeros(R2, np.int32)
        r2_end = np.zeros(R2, np.int32)
        r2_m = np.ones(R2, np.int64)
        r2_read[:n_r2] = r2_reads
        r2_start[:n_r2] = r2_mid
        r2_end[:n_r2] = lens[r2_reads]
        r2_m[:n_r2] = r2_min
        rd2 = rd[jnp.asarray(r2_read)]
        CAP2 = 16
        r2_steps_a = min(4 * L, 32 * L)
        pk2 = min_starts_twoptr(
            fmd, rd2, jnp.asarray(r2_start), jnp.asarray(r2_end),
            jnp.asarray(r2_m), L, max_steps=r2_steps_a, bwd_init=True,
            emit_direct=True, min_seed=int(min_seed), cap=CAP2,
            mid=jnp.asarray(r2_start))
        (meta2, big2), flags2 = _twophase_finish(
            pk2, CAP2, r2_start.astype(np.int64), r2_end.astype(np.int64),
            r2_m, r2_start.astype(np.int64), True, 32 * L, read_rows=rd2)
        if SEED_TRACE:
            print(f"[seedtrace] r2 lanes={n_r2} flags={flags2}",
                  flush=True)
        if flags2 != 1:
            # step cap / slot overflow (rare): exhaustive kernel over the
            # family lanes + full-plane host emission
            lane_read, lane_e, lane_m, lane_req = [], [], [], []
            for j in range(n_r2):
                for e in range(int(r2_mid[j]) + 1,
                               int(lens[r2_reads[j]]) + 1):
                    lane_read.append(int(r2_reads[j]))
                    lane_e.append(e)
                    lane_m.append(int(r2_min[j]))
                    lane_req.append(j)
            bf, x0f, x1f, sf, vf = min_starts_kernel(
                fmd, rd, jnp.asarray(np.array(lane_read, np.int32)),
                jnp.asarray(np.array(lane_e, np.int32)),
                jnp.asarray(np.array(lane_m, np.int64)), L)
            b2h = np.zeros((R2, L), np.int64)
            x02h = np.zeros((R2, L), np.int64)
            x12h = np.zeros((R2, L), np.int64)
            s2h = np.zeros((R2, L), np.int64)
            v2h = np.zeros((R2, L), bool)
            lr, le = np.array(lane_req), np.array(lane_e) - 1
            b2h[lr, le] = np.asarray(bf)
            x02h[lr, le] = np.asarray(x0f)
            x12h[lr, le] = np.asarray(x1f)
            s2h[lr, le] = np.asarray(sf)
            v2h[lr, le] = np.asarray(vf)
            rj2, m2 = _emit_full(
                b2h[:n_r2], x02h[:n_r2], x12h[:n_r2], s2h[:n_r2],
                v2h[:n_r2], r2_mid.astype(np.int64),
                lens[r2_reads].astype(np.int64),
                r2_mid.astype(np.int64))
            ri2 = r2_reads[rj2].astype(np.int64)
        else:
            cnt2 = meta2[:n_r2, CAP2]
            kmask2 = (np.arange(CAP2, dtype=np.int32)[None, :]
                      < cnt2[:, None])
            rj2, kj2 = np.nonzero(kmask2)  # request-major, e-ascending
            qbqe2 = meta2[:n_r2, :CAP2][rj2, kj2].astype(np.int64)
            b2 = big2[:n_r2]
            m2 = np.stack([b2[:, 0 * CAP2:1 * CAP2][rj2, kj2].astype(
                               np.int64),
                           b2[:, 1 * CAP2:2 * CAP2][rj2, kj2].astype(
                               np.int64),
                           b2[:, 2 * CAP2:3 * CAP2][rj2, kj2].astype(
                               np.int64),
                           qbqe2 >> 16, qbqe2 & 0xFFFF], axis=1)
            ri2 = r2_reads[rj2].astype(np.int64)
    else:
        m2 = np.zeros((0, 5), np.int64)
        ri2 = np.zeros(0, np.int64)

    _t = _strace("r2", _t)
    # ---- round 3: forward-greedy walker ----------------------------------
    if pk3 is not None:
        meta3 = np.asarray(pk3[0])         # sync for round 3 (pre-fetched)
        big3 = np.asarray(pk3[1]).astype(np.int64)
        C3 = meta3.shape[1] - 1
        n3 = meta3[:, C3].astype(np.int64)
        qb3 = (meta3[:, :C3] >> 16).astype(np.int64)
        qe3 = (meta3[:, :C3] & 0xFFFF).astype(np.int64)
        ox0 = big3[:, 0 * C3:1 * C3]
        ox1 = big3[:, 1 * C3:2 * C3]
        os3 = big3[:, 2 * C3:3 * C3]
        k3 = np.arange(C3, dtype=np.int64)[None, :]
        emit3 = (k3 < n3[:, None]) & (os3 > 0)
        ri3, ki3 = np.nonzero(emit3)       # read-major, k-ascending
        m3 = np.stack([ox0[ri3, ki3], ox1[ri3, ki3], os3[ri3, ki3],
                       qb3[ri3, ki3], qe3[ri3, ki3]], axis=1)
    else:
        m3 = np.zeros((0, 5), np.int64)
        ri3 = np.zeros(0, np.int64)

    _t = _strace("r3 assembly", _t)
    # ---- merge + final stable (qb, qe) sort per read (collect_intv) ------
    rid = np.concatenate([ri1.astype(np.int64), ri2, ri3.astype(np.int64)])
    mall = np.concatenate([m1, m2, m3], axis=0)
    seq = np.arange(len(rid), dtype=np.int64)  # emission order within read
    order = np.lexsort((seq, mall[:, 4], mall[:, 3], rid))
    rid = rid[order]
    mall = mall[order]
    counts = np.bincount(rid, minlength=R)[:n_reads]
    splits = np.cumsum(counts)[:-1]
    out = [a.reshape(-1, 5) for a in np.split(mall, splits)]
    _strace("merge+sort", _t)
    return out


def collect_seeds_device(fmd: DeviceFMIndex, fm, reads: List[np.ndarray],
                         opt) -> List[List[Tuple]]:
    """Tuple-list view of collect_seeds_arrays_device (test surface)."""
    arrs = collect_seeds_arrays_device(fmd, fm, reads, opt)
    return [[tuple(int(v) for v in row) for row in a.tolist()]
            for a in arrs]


def collect_seeds_rbegs_device(dfm: DeviceFMIndex, dg, fm,
                               reads: List[np.ndarray], opt):
    """Device twin of native fm_collect_seeds_rbegs_batch: 3-round SMEM
    enumeration + the occurrence schedule's SA dereference, both on device.

    Returns (mems_per_read, rbegs_per_read) in the exact native format:
    (n, 5) int64 arrays [x0, x1, s, qb, qe] and int64 rbeg arrays in
    enumerate_occurrences order (step-sampled above max_occ).
    """
    from ..parallel.align_step import sa_lookup_batch_host

    mems = collect_seeds_arrays_device(dfm, fm, reads, opt)
    _t = _time.time()
    max_occ = int(opt.max_occ)
    if mems:
        flat = np.concatenate([m for m in mems], axis=0)
    else:
        flat = np.zeros((0, 5), np.int64)
    sv = flat[:, 2]
    x0v = flat[:, 0]
    step = np.where(sv > max_occ, sv // np.int64(max_occ), np.int64(1))
    cnt = np.where(sv > max_occ, np.int64(max_occ), sv)
    total = int(cnt.sum())
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
    within = (np.arange(total, dtype=np.int64)
              - np.repeat(starts, cnt))
    rows_arr = np.repeat(x0v, cnt) + within * np.repeat(step, cnt)
    if total:
        _t = _strace("rbeg schedule", _t)
        out = sa_lookup_batch_host(dg, fm, rows_arr)
        _t = _strace("sa walk", _t)
    else:
        out = np.zeros(0, np.int64)
    per_seed = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    rbegs = []
    seed_off = 0
    for m in mems:
        lo = per_seed[seed_off]
        hi = per_seed[seed_off + len(m)] if len(m) else lo
        rbegs.append(out[lo:hi].astype(np.int64))
        seed_off += len(m)
    return mems, rbegs
