"""Batched device SW-extend vs scalar host reference: exact equality."""

import numpy as np
import pytest

from lariat_tpu.align import ksw
from lariat_tpu.ops import sw_batch

MAT = ksw.fill_score_matrix(1, 4)


def _random_tasks(rng, n, lq_max=120, lt_max=250):
    tasks = []
    for _ in range(n):
        qlen = int(rng.integers(0, lq_max))
        tlen = int(rng.integers(0, lt_max))
        ref = rng.integers(0, 4, max(tlen, qlen) + 10)
        q = ref[:qlen].copy()
        for _ in range(int(rng.integers(0, 5))):
            if qlen:
                p = int(rng.integers(0, qlen))
                q[p] = (q[p] + rng.integers(1, 4)) % 4
        t = ref[:tlen].copy()
        h0 = int(rng.integers(15, 60))
        w = int(rng.choice([20, 100, 200]))
        tasks.append((q, t, h0, w))
    return tasks


@pytest.mark.parametrize("seed", range(4))
def test_extend_batch_equals_host(seed):
    rng = np.random.default_rng(seed)
    tasks = _random_tasks(rng, 32)
    Lq = max((len(q) for q, _, _, _ in tasks), default=1) or 1
    Lt = max((len(t) for _, t, _, _ in tasks), default=1) or 1
    B = len(tasks)
    qa = np.zeros((B, Lq), np.int32)
    ta = np.zeros((B, Lt), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.zeros(B, np.int32)
    w = np.zeros(B, np.int32)
    for i, (q, t, h, ww) in enumerate(tasks):
        qa[i, :len(q)] = q
        ta[i, :len(t)] = t
        qlen[i], tlen[i], h0[i], w[i] = len(q), len(t), h, ww
    res = sw_batch.extend_batch(qa, qlen, ta, tlen, np.asarray(MAT), w, h0)
    for i, (q, t, h, ww) in enumerate(tasks):
        want = ksw.extend(q.astype(np.int64), t.astype(np.int64), MAT,
                          6, 1, 6, 1, ww, 5, 100, h)
        got = (int(res.score[i]), int(res.qle[i]), int(res.tle[i]),
               int(res.gtle[i]), int(res.gscore[i]), int(res.max_off[i]))
        wanted = (want.score, want.qle, want.tle, want.gtle, want.gscore,
                  want.max_off)
        assert got == wanted, (seed, i, got, wanted, len(q), len(t), h, ww)


@pytest.mark.parametrize("Lq,Lt", [(64, 192), (192, 576)])
def test_extend_wave_resident_151bp_tiers(Lq, Lt):
    """The engine's extend wave (resident gather + XLA extend) at the
    151 bp tier shapes equals ksw.extend per task, for forward and
    backward target fetches on both strands of the doubled text."""
    import jax
    from lariat_tpu.ops import resident
    rng = np.random.default_rng(Lt)
    l_pac = 4000
    genome = rng.integers(0, 4, l_pac).astype(np.uint8)
    fmd = np.concatenate([genome, (3 - genome)[::-1]])
    words = np.zeros(-(-l_pac // 16), np.uint32)
    for i, c in enumerate(genome):
        words[i >> 4] |= np.uint32(int(c) << (2 * (15 - (i & 15))))
    B = 48
    qs, ts, rows = [], [], []
    reads = np.full((B, Lq), 4, np.uint8)
    for b in range(B):
        tlen = int(rng.integers(1, Lt + 1))
        tdir = 1 if b % 2 else -1
        start = int(rng.integers(Lt, 2 * l_pac - Lt))
        t = fmd[start + tdir * np.arange(tlen)]
        qlen = int(rng.integers(1, min(Lq, tlen) + 1))
        q = t[:qlen].copy()
        hit = rng.random(qlen) < 0.05
        q[hit] = (q[hit] + 1) % 4
        reads[b, :qlen] = q
        h0 = int(rng.integers(19, 152))
        w = int(rng.choice([100, 200]))
        qs.append(q)
        ts.append(t)
        rows.append((b, 0, 1, qlen, start, tdir, tlen, h0, w))
    desc = resident.pack_desc(*np.array(rows).T, l_pac=l_pac)
    out = np.asarray(resident.extend_wave_resident(
        jax.device_put(reads), jax.device_put(words), l_pac, desc,
        np.asarray(MAT), Lq=Lq, Lt=Lt, opt_key=(6, 1, 6, 1, 5, 100)))
    assert out.shape == (6, B)
    for b, (q, t) in enumerate(zip(qs, ts)):
        want = ksw.extend(q.astype(np.int64), t.astype(np.int64), MAT,
                          6, 1, 6, 1, int(rows[b][8]), 5, 100,
                          int(rows[b][7]))
        assert tuple(int(v) for v in out[:, b]) == (
            want.score, want.qle, want.tle, want.gtle, want.gscore,
            want.max_off), b
