"""Device 3-round SMEM enumeration vs the native C++ (bit-for-bit)."""

import numpy as np
import pytest

from lariat_tpu.align.engine import AlignmentEngine, encode_read
from lariat_tpu.config import AlignerConfig
from lariat_tpu.index import native_ops
from lariat_tpu.ops import fm_batch, smem_device

from test_rfa import dup_genome  # noqa: F401


def _messy_reads(genome: bytes, rng, n=60):
    """Clean, mutated, reversed, N-riddled, short and long reads."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for i in range(n):
        ln = int(rng.integers(15, 152))
        pos = int(rng.integers(0, len(genome) - ln))
        seg = bytearray(genome[pos:pos + ln])
        nmut = int(rng.integers(0, 6))
        for _ in range(nmut):
            p = int(rng.integers(0, ln))
            seg[p] = b"ACGTN"[int(rng.integers(0, 5))]
        if rng.integers(0, 2):
            seg = bytearray(bytes(seg).translate(comp)[::-1])
        out.append(encode_read(bytes(seg)))
    # degenerate cases
    out.append(encode_read(b"ACGT"))
    out.append(encode_read(b"N" * 30))
    out.append(encode_read(b"ACGTN" * 25))
    return out


def test_collect_seeds_device_matches_native(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    opt = AlignerConfig()
    rng = np.random.default_rng(77)
    reads = _messy_reads(genome, rng)
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        pytest.skip("native seeding unavailable")
    mems_native, _rbegs = want
    dfm = fm_batch.DeviceFMIndex.from_host(fm)
    got = smem_device.collect_seeds_device(dfm, fm, reads, opt)
    assert len(got) == len(mems_native)
    for i, (g, w) in enumerate(zip(got, mems_native)):
        w_rows = [tuple(int(v) for v in row) for row in np.asarray(w)]
        assert g == w_rows, (
            f"read {i}: device {g[:6]}... vs native {w_rows[:6]}...")


def test_collect_seeds_device_segdup_heavy(dup_genome):  # noqa: F811
    """Reads inside the duplicated segment (multi-occurrence seeds, round-2
    re-seeding fires) must match too."""
    fm, genome = dup_genome
    opt = AlignerConfig()
    rng = np.random.default_rng(78)
    reads = []
    for i in range(30):
        pos = 2000 + int(rng.integers(0, 900))
        ln = int(rng.integers(60, 152))
        reads.append(encode_read(genome[pos:pos + ln]))
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        pytest.skip("native seeding unavailable")
    mems_native, _ = want
    dfm = fm_batch.DeviceFMIndex.from_host(fm)
    got = smem_device.collect_seeds_device(dfm, fm, reads, opt)
    for i, (g, w) in enumerate(zip(got, mems_native)):
        w_rows = [tuple(int(v) for v in row) for row in np.asarray(w)]
        assert g == w_rows, f"read {i}"


def test_collect_seeds_rbegs_device_matches_native(dup_genome):  # noqa: F811
    """Full device seeding incl. SA-walked rbegs == native, bit-for-bit."""
    from lariat_tpu.parallel.align_step import DeviceGenome
    fm, genome = dup_genome
    opt = AlignerConfig()
    rng = np.random.default_rng(79)
    reads = _messy_reads(genome, rng, n=40)
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        pytest.skip("native seeding unavailable")
    w_mems, w_rbegs = want
    dfm = fm_batch.DeviceFMIndex.from_host(fm)
    dg = DeviceGenome.from_host(fm)
    g_mems, g_rbegs = __import__(
        "lariat_tpu.ops.smem_device", fromlist=["x"]
    ).collect_seeds_rbegs_device(dfm, dg, fm, reads, opt)
    for i in range(len(reads)):
        np.testing.assert_array_equal(
            g_mems[i], np.asarray(w_mems[i]).reshape(-1, 5), err_msg=str(i))
        np.testing.assert_array_equal(g_rbegs[i], w_rbegs[i],
                                      err_msg=str(i))


def test_align_batch_with_device_seed(dup_genome, monkeypatch):  # noqa: F811
    """The full session path with LARIAT_DEVICE_SEED=1 produces identical
    candidate regions to the host-seeded path."""
    from lariat_tpu.align.batch_engine import BatchAlignmentEngine
    fm, genome = dup_genome
    rng = np.random.default_rng(80)
    seqs = []
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for i in range(25):
        ln = int(rng.integers(40, 152))
        pos = int(rng.integers(0, len(genome) - ln))
        seg = bytearray(genome[pos:pos + ln])
        for _ in range(int(rng.integers(0, 4))):
            seg[int(rng.integers(0, ln))] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            seg = bytearray(bytes(seg).translate(comp)[::-1])
        seqs.append(bytes(seg))
    eng = BatchAlignmentEngine(fm)
    host_regs = eng.align_batch(seqs)
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    eng2 = BatchAlignmentEngine(fm)
    dev_regs = eng2.align_batch(seqs)
    assert host_regs == dev_regs


def test_twoptr_low_complexity_and_fallback(dup_genome):  # noqa: F811
    """Two-pointer machine on pathological low-complexity reads: agrees
    with the exhaustive per-(read, e) kernel, and the step-cap fallback
    path produces the same collect output."""
    import jax.numpy as jnp

    fm, genome = dup_genome
    opt = AlignerConfig()
    dfm = fm_batch.DeviceFMIndex.from_host(fm)
    reads = [
        encode_read(b"A" * 151),
        encode_read(b"AT" * 75),
        encode_read(b"ACG" * 50),
        encode_read((b"A" * 30 + b"N") * 4),
        encode_read(genome[100:151] + b"A" * 40),
    ]
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        pytest.skip("native seeding unavailable")
    mems_native, _ = want
    got = smem_device.collect_seeds_device(dfm, fm, reads, opt)
    for i, (g, w) in enumerate(zip(got, mems_native)):
        w_rows = [tuple(int(v) for v in row) for row in np.asarray(w)]
        assert g == w_rows, f"read {i}"
    # direct function equivalence incl. per-e arrays
    L = 192
    R = 8
    rmat = np.full((R, L), 4, np.uint8)
    lens = np.zeros(R, np.int32)
    for i, r in enumerate(reads):
        rmat[i, :len(r)] = r
        lens[i] = len(r)
    rd = jnp.asarray(rmat)
    b, x0, x1, s, valid, done = smem_device.min_starts_twoptr(
        dfm, rd, jnp.zeros(R, np.int32), jnp.asarray(lens),
        jnp.ones(R, np.int64), L)
    assert bool(done)
    read_idx = np.repeat(np.arange(R, dtype=np.int32), L)
    e_arr = np.tile(np.arange(1, L + 1, dtype=np.int32), R)
    bq, x0q, x1q, sq, vq = smem_device.min_starts_kernel(
        dfm, rd, jnp.asarray(read_idx), jnp.asarray(e_arr),
        jnp.ones(R * L, np.int64), L)
    vq = np.asarray(vq).reshape(R, L)
    # quadratic kernel computes e > lens columns too; mask both to lens
    emask = (np.arange(1, L + 1)[None, :] <= lens[:, None])
    v2 = np.asarray(valid) & emask
    vq = vq & emask
    np.testing.assert_array_equal(v2, vq)
    for name, a, qarr in (("b", b, bq), ("x0", x0, x0q),
                          ("x1", x1, x1q), ("s", s, sq)):
        qm = np.asarray(qarr).reshape(R, L)
        np.testing.assert_array_equal(
            np.where(v2, np.asarray(a), 0), np.where(v2, qm, 0),
            err_msg=name)


def test_two_phase_straggler_split(dup_genome):  # noqa: F811
    """Tiny phase-A budgets force the straggler rerun for (almost) every
    lane; the spliced result must still match the native C++ exactly."""
    fm, genome = dup_genome
    opt = AlignerConfig()
    rng = np.random.default_rng(123)
    reads = _messy_reads(genome, rng, n=40)
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        pytest.skip("native seeding unavailable")
    dfm = fm_batch.DeviceFMIndex.from_host(fm)
    import lariat_tpu.ops.smem_device as sd
    src = sd.collect_seeds_arrays_device.__globals__  # same module dict
    # shrink the phase-A budgets via the module-level expressions: patch
    # min_starts_twoptr to clamp max_steps on the FIRST (phase A) call of
    # each round, leaving reruns at full budget
    orig = sd.min_starts_twoptr
    calls = {"n": 0}

    def clamped(*a, **kw):
        calls["n"] += 1
        # phase-A calls pass the r*_steps_a budgets (3L/4L); shrink those
        if kw.get("max_steps", 0) in (3 * 192, 4 * 192):
            kw["max_steps"] = 24      # force stragglers
        return orig(*a, **kw)

    sd.min_starts_twoptr = clamped
    try:
        got = sd.collect_seeds_device(dfm, fm, reads, opt)
    finally:
        sd.min_starts_twoptr = orig
    mems_native, _ = want
    for i, (g, w) in enumerate(zip(got, mems_native)):
        w_rows = [tuple(int(v) for v in row) for row in np.asarray(w)]
        assert g == w_rows, f"read {i}"
    assert calls["n"] >= 3   # phase A x2 + at least one straggler rerun


def test_sa_lookup_batch_host_matches_scalar(dup_genome):  # noqa: F811
    fm, _ = dup_genome
    from lariat_tpu.parallel.align_step import (DeviceGenome,
                                                sa_lookup_batch_host)
    dg = DeviceGenome.from_host(fm)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, fm.seq_len, 700).astype(np.int64)
    got = sa_lookup_batch_host(dg, fm, rows, phase_steps=4)  # force phase B
    want = np.array([fm.sa_lookup(int(r)) for r in rows], np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stage", ["upload", "collect"])
def test_forced_device_seeding_failure_raises(dup_genome, monkeypatch,
                                              stage):  # noqa: F811
    """LARIAT_DEVICE_SEED=1 is a hard requirement: a failing index upload
    or seeding call raises instead of falling back to the host seeder."""
    from lariat_tpu.align.batch_engine import BatchAlignmentEngine
    from lariat_tpu.ops import fm_batch, smem_device

    def boom(*a, **kw):
        raise RuntimeError(f"injected {stage} failure")

    if stage == "upload":
        monkeypatch.setattr(fm_batch.DeviceFMIndex, "from_host", boom)
    else:
        monkeypatch.setattr(smem_device, "collect_seeds_rbegs_device", boom)
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    fm, genome = dup_genome
    eng = BatchAlignmentEngine(fm)
    with pytest.raises(RuntimeError, match=f"injected {stage} failure"):
        eng.align_batch([genome[100:251]])


def test_smem_unroll_below_one_is_rejected():
    """LARIAT_SMEM_UNROLL=0 would never advance the SMEM loop: importing
    the module refuses it."""
    import os
    import subprocess
    import sys
    r = subprocess.run(
        [sys.executable, "-c", "import lariat_tpu.ops.smem_device"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "LARIAT_SMEM_UNROLL": "0"})
    assert r.returncode != 0
    assert "LARIAT_SMEM_UNROLL must be >= 1" in r.stderr
