"""Batched local-SW (mate rescue DP) equality vs the host reference.

The host reference is ``ksw.local_align`` (numpy + native SSE2, themselves
cross-checked); the device paths must be bit-identical per task.
"""

import numpy as np
import pytest

from lariat_tpu.align import ksw


def _rand_tasks(rng, n, qmax=96, tmax=160, mutate=True):
    tasks = []
    for _ in range(n):
        ql = int(rng.integers(1, qmax))
        tl = int(rng.integers(1, tmax))
        t = rng.integers(0, 4, tl).astype(np.int64)
        if mutate and tl > ql:
            # plant the query inside the target with a few mutations so
            # positive scores and second-best candidates actually occur
            off = int(rng.integers(0, tl - ql))
            q = t[off:off + ql].copy()
            nmut = int(rng.integers(0, max(2, ql // 12)))
            for _ in range(nmut):
                p = int(rng.integers(0, ql))
                q[p] = (q[p] + 1 + rng.integers(0, 3)) % 4
        else:
            q = rng.integers(0, 5, ql).astype(np.int64)
        tasks.append((q, t))
    return tasks


def _pad_batch(tasks, Lq, Lt):
    B = len(tasks)
    q = np.zeros((B, Lq), np.int32)
    t = np.zeros((B, Lt), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for i, (qi, ti) in enumerate(tasks):
        q[i, :len(qi)] = qi
        t[i, :len(ti)] = ti
        qlen[i] = len(qi)
        tlen[i] = len(ti)
    return q, qlen, t, tlen


@pytest.mark.parametrize("seed", [0, 1])
def test_local_batch_xla_matches_reference(seed):
    from lariat_tpu.ops.sw_local_batch import local_batch
    rng = np.random.default_rng(seed)
    mat = ksw.fill_score_matrix(1, 4)
    tasks = _rand_tasks(rng, 80) + _rand_tasks(rng, 20, mutate=False)
    Lq = max(len(q) for q, _ in tasks)
    Lt = max(len(t) for _, t in tasks)
    q, qlen, t, tlen = _pad_batch(tasks, Lq, Lt)
    minsc = 19
    res = local_batch(q, qlen, t, tlen, np.asarray(mat),
                      np.full(len(tasks), minsc, np.int32), max_sc=1)
    score = np.asarray(res.score)
    te = np.asarray(res.te)
    qe = np.asarray(res.qe)
    score2 = np.asarray(res.score2)
    te2 = np.asarray(res.te2)
    for i, (qi, ti) in enumerate(tasks):
        ref = ksw._local_core(qi, ti, mat, 6, 1, 6, 1, minsc, 1 << 30)
        g_ref, te_ref, qe_ref, s2_ref, te2_ref = ref
        if te_ref < 0:
            g_ref, te_ref, qe_ref, s2_ref, te2_ref = 0, -1, -1, -1, -1
        assert (score[i], te[i], qe[i], score2[i], te2[i]) == \
            (g_ref, te_ref, qe_ref, s2_ref, te2_ref), f"task {i}"


def test_local_align_batch_matches_local_align():
    from lariat_tpu.align.ksw import local_align_batch
    rng = np.random.default_rng(7)
    mat = ksw.fill_score_matrix(1, 4)
    tasks = _rand_tasks(rng, 60) + _rand_tasks(rng, 15, mutate=False)
    minsc = 19
    out = local_align_batch([(q, t) for q, t in tasks], mat,
                            6, 1, 6, 1, minsc)
    for i, (qi, ti) in enumerate(tasks):
        ref = ksw.local_align(qi, ti, mat, 6, 1, 6, 1, minsc)
        assert out[i] == ref, f"task {i}: {out[i]} vs {ref}"


@pytest.mark.parametrize("q_tiers,t_tiers,n", [
    (None, None, 5),
    ((192, 768), (704, 1408), 130),
    ((64,), (64,), 3),
])
def test_local_align_batch_wrapper_shapes(monkeypatch, q_tiers, t_tiers, n):
    """local_align_batch pads lengths to the rescue tiers (64-multiples
    past them or without them) and the batch to a power of two >= 128,
    fills pad rows with never-scoring minsc, and still matches
    ksw.local_align per task."""
    from lariat_tpu.align import ksw as ksw_mod
    from lariat_tpu.ops import sw_local_batch
    rng = np.random.default_rng(n)
    mat = ksw.fill_score_matrix(1, 4)
    tasks = _rand_tasks(rng, n, qmax=151, tmax=700)
    seen = {}
    real = sw_local_batch.local_two_pass

    def spy(qa, qlen, ta, tlen, m, minscs, **kw):
        seen.update(q=qa.shape, t=ta.shape, qlen=np.asarray(qlen),
                    minsc=np.asarray(minscs))
        return real(qa, qlen, ta, tlen, m, minscs, **kw)

    monkeypatch.setattr(sw_local_batch, "local_two_pass", spy)
    out = ksw_mod.local_align_batch(tasks, mat, 6, 1, 6, 1, 19,
                                    q_tiers=q_tiers, t_tiers=t_tiers)
    Bp, Lq, Lt = ksw_mod.local_wave_shape(tasks, q_tiers, t_tiers)
    assert seen["q"] == (Bp, Lq) and seen["t"] == (Bp, Lt)
    assert Bp >= max(128, n) and Bp & (Bp - 1) == 0
    qmax = max(len(q) for q, _ in tasks)
    tmax = max(len(t) for _, t in tasks)
    assert Lq == ksw_mod._pad_tier(qmax, q_tiers) >= qmax
    assert Lt == ksw_mod._pad_tier(tmax, t_tiers) >= tmax
    assert Lq % 64 == 0 and Lt % 64 == 0
    assert (seen["qlen"][n:] == 0).all()
    assert (seen["minsc"][n:] == 1 << 30).all()
    for i, (qi, ti) in enumerate(tasks):
        assert out[i] == ksw.local_align(qi, ti, mat, 6, 1, 6, 1, 19), i


def test_local_align_batch_empty_and_edge():
    from lariat_tpu.align.ksw import local_align_batch
    mat = ksw.fill_score_matrix(1, 4)
    e = np.zeros(0, np.int64)
    s = np.array([0, 1, 2, 3], np.int64)
    out = local_align_batch([(e, s), (s, e), (s, s)], mat, 6, 1, 6, 1, 2)
    for got, (qi, ti) in zip(out, [(e, s), (s, e), (s, s)]):
        ref = ksw.local_align(qi, ti, mat, 6, 1, 6, 1, 2)
        assert got == ref


def test_local_align_batch_native_matches_scalar():
    """One-FFI-call host batch == per-task ksw.local_align (fuzz)."""
    import numpy as np
    from lariat_tpu.align import ksw

    rng = np.random.default_rng(77)
    mat = ksw.fill_score_matrix(1, 4)
    tasks = []
    for _ in range(60):
        lq = int(rng.integers(1, 160))
        lt = int(rng.integers(1, 500))
        q = rng.integers(0, 5, lq).astype(np.uint8)
        t = rng.integers(0, 5, lt).astype(np.uint8)
        if lt > lq:  # plant the query so positive scores occur
            off = int(rng.integers(0, lt - lq))
            t[off:off + lq] = q[:lq]
        tasks.append((q, t))
    got = ksw.local_align_batch_native(tasks, mat, 6, 1, 6, 1, 19)
    if got is None:
        import pytest
        pytest.skip("native library unavailable")
    for (q, t), g in zip(tasks, got):
        want = ksw.local_align(q.astype(np.int64), t.astype(np.int64), mat,
                               6, 1, 6, 1, 19)
        assert g == want
