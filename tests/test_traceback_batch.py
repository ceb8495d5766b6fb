"""Traceback over the XLA global DP's band-packed output: the device walk
(and its bit-packed single-buffer download) vs the per-task host walk."""

import numpy as np
import pytest

from lariat_tpu.align import ksw
from lariat_tpu.ops import sw_global_batch

MAT = np.asarray(ksw.fill_score_matrix(1, 4))


def _tasks(rng, n, widths=(10, 25, 100), qmax=110, slack=4):
    tasks = []
    for _ in range(n):
        ql = int(rng.integers(5, qmax))
        ref = rng.integers(0, 4, qmax + 2 * slack + 8)
        q = ref[:ql].copy()
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, ql))
            q[p] = (q[p] + rng.integers(1, 4)) % 4
        t = ref[:max(1, ql + int(rng.integers(-slack, slack + 1)))].copy()
        w = max(int(rng.choice(widths)), abs(len(q) - len(t)))
        tasks.append((q, t, w))
    return tasks


def _wave(tasks, pad_rows=0):
    """Run one XLA global wave; returns (res, qlen, tlen, wv, S)."""
    B = len(tasks) + pad_rows
    Lq = -(-max(len(q) for q, _, _ in tasks) // 64) * 64
    Lt = -(-max(len(t) for _, t, _ in tasks) // 64) * 64
    qa = np.zeros((B, Lq), np.int32)
    ta = np.zeros((B, Lt), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    wv = np.ones(B, np.int32)
    for i, (q, t, w) in enumerate(tasks):
        qa[i, :len(q)] = q
        ta[i, :len(t)] = t
        qlen[i], tlen[i], wv[i] = len(q), len(t), w
    n_col = min(Lq, 2 * int(wv.max()) + 1)
    res = sw_global_batch.global_batch(qa, qlen, ta, tlen, MAT, wv, n_col)
    return res, qlen, tlen, wv, Lq + Lt


def _host_walks(res, tasks):
    z = np.asarray(res.z)
    begs = np.asarray(res.beg)
    return [sw_global_batch.traceback(z[i], begs[i], len(q), len(t), w)
            for i, (q, t, w) in enumerate(tasks)]


def test_traceback_batch_parity():
    """The device walk of a whole wave == the per-task host walk over the
    downloaded bytes."""
    tasks = _tasks(np.random.default_rng(5), 40)
    res, qlen, tlen, wv, S = _wave(tasks)
    ops, i_fin, k_fin = sw_global_batch.traceback_ops_device(
        res.z, qlen, tlen, wv, S=S)
    dev = sw_global_batch.cigars_from_ops(
        np.asarray(ops), np.asarray(i_fin), np.asarray(k_fin))
    for i, want in enumerate(_host_walks(res, tasks)):
        assert dev[i] == want, (i, dev[i], want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("width", [5, 20, 100])
def test_device_walk_equals_host_walk(seed, width):
    """XLA global DP + device walker == the host walk == ksw.global_align,
    over seeds and band widths (narrow bands force the band edges)."""
    rng = np.random.default_rng(1000 * width + seed)
    tasks = _tasks(rng, 16, widths=(width,), qmax=150, slack=6)
    res, qlen, tlen, wv, S = _wave(tasks)
    ops, i_fin, k_fin = sw_global_batch.traceback_ops_device(
        res.z, qlen, tlen, wv, S=S)
    dev = sw_global_batch.cigars_from_ops(
        np.asarray(ops), np.asarray(i_fin), np.asarray(k_fin))
    host = _host_walks(res, tasks)
    for i, (q, t, w) in enumerate(tasks):
        score, cigar = ksw.global_align(q.astype(np.int64),
                                        t.astype(np.int64), MAT, 6, 1, 6, 1,
                                        w)
        assert int(res.score[i]) == score, i
        assert dev[i] == host[i] == cigar, i


def test_device_traceback_matches_host_walk():
    """traceback_ops_device + cigars_from_ops == the host walk, with a
    padding row that exercises the inactive-lane path."""
    tasks = _tasks(np.random.default_rng(13), 11, widths=(5, 12, 29),
                   qmax=80)
    res, qlen, tlen, wv, S = _wave(tasks, pad_rows=1)
    ops_buf, i_fin, k_fin = sw_global_batch.traceback_ops_device(
        res.z, qlen, tlen, wv, S=S)
    got = sw_global_batch.cigars_from_ops(
        np.asarray(ops_buf), np.asarray(i_fin), np.asarray(k_fin))
    want = _host_walks(res, tasks)
    for b in range(len(tasks)):
        assert got[b] == want[b], b
    # the padding row (qlen = tlen = 0) walks nothing
    assert (np.asarray(ops_buf)[-1] == 255).all()


@pytest.mark.parametrize("seed", range(2))
def test_traceback_ops_fused_packed_matches_raw(seed):
    """The 4-ops/byte fused download path == the raw uint8 path (and the
    host reference cigars and scores)."""
    tasks = _tasks(np.random.default_rng(seed + 170), 10, widths=(10, 25),
                   qmax=96, slack=6)
    res, qlen, tlen, wv, S = _wave(tasks)
    blob = np.asarray(sw_global_batch.traceback_ops_fused(
        res.z, qlen, tlen, wv, res.score, S=S))
    assert blob.shape == (len(tasks), S // 4 + 12)
    packed, score, i_fin, k_fin = sw_global_batch.split_traceback_blob(
        blob, S)
    got = sw_global_batch.cigars_from_ops_packed(packed, i_fin, k_fin, S)
    assert got is not None, "native packed finisher missing"
    cig_mat, nops = got
    ops_buf, i2, k2 = sw_global_batch.traceback_ops_device(
        res.z, qlen, tlen, wv, S=S)
    raw = sw_global_batch.cigars_from_ops_raw(
        np.asarray(ops_buf), np.asarray(i2), np.asarray(k2))
    assert raw is not None
    cig_raw, nops_raw = raw
    np.testing.assert_array_equal(nops, nops_raw)
    for i, (q, t, w) in enumerate(tasks):
        n = int(nops[i])
        pairs = list(zip(cig_mat[i, 0:2 * n:2].tolist(),
                         cig_mat[i, 1:2 * n:2].tolist()))
        want_score, want_cigar = ksw.global_align(
            q.astype(np.int64), t.astype(np.int64), MAT, 6, 1, 6, 1, w)
        assert int(score[i]) == want_score, (seed, i)
        assert pairs == want_cigar, (seed, i)
