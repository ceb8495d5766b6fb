"""Batch engine must be bit-identical to the sequential host engine."""

import dataclasses

import numpy as np
import pytest

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.align.engine import AlignmentEngine, encode_read
from lariat_tpu.index import fmindex

from test_rfa import dup_genome  # noqa: F401

COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _reads(genome, rng, n=24):
    out = []
    for _ in range(n):
        ln = int(rng.integers(60, 151))
        pos = int(rng.integers(0, len(genome) - ln))
        seq = bytearray(genome[pos:pos + ln])
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, ln))
            seq[p] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            seq = bytearray(bytes(seq).translate(COMP)[::-1])
        # occasional junk tail to force soft clips
        if rng.integers(0, 4) == 0:
            seq += bytes(b"ACGT"[int(rng.integers(0, 4))]
                         for _ in range(20))
        out.append(bytes(seq))
    return out


def test_batch_engine_matches_host(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(31)
    seqs = _reads(genome, rng)
    got_all = batch.align_batch(seqs)
    for seq, got in zip(seqs, got_all):
        want = host.align1(encode_read(seq))
        assert len(got) == len(want), seq
        for g, w in zip(got, want):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), seq


def test_batch_engine_phix_golden(request):
    inputs = request.getfixturevalue("reference_inputs")
    fm = fmindex.load_bwa_index(str(inputs / "phix" / "PhiX.fa"))
    batch = BatchAlignmentEngine(fm)
    read = (b"TCAAAAACTGACGCGTTGGATGAGGAGAAGTGGCTTAATATGCTTGGCACGTTCGTCAAG"
            b"GACTGGTTTA")
    regs = batch.align_batch([read])[0]
    ea = batch.interpret_align(regs[0])
    assert (ea.contig, ea.offset, regs[0].score) == ("PhiX", 210, 70)


def test_reg2aln_batch_matches_host(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(41)
    seqs = _reads(genome, rng, n=20)
    tasks = []
    for seq in seqs:
        for reg in host.align1(encode_read(seq)):
            tasks.append((seq, reg))
    got = batch.reg2aln_batch(tasks)
    for (seq, reg), g in zip(tasks, got):
        w = host.reg2aln(seq, reg)
        assert g == w, (seq, reg)


def test_process_barcode_batched_matches_serial(dup_genome):  # noqa: F811
    from lariat_tpu.config import RFAConfig
    from lariat_tpu.rfa.pipeline import process_barcode
    from test_rfa import _make_pair
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    reads = []
    for i, pos in enumerate(range(1500, 3100, 200)):
        reads.append(_make_pair(genome, pos, 300, f"m1:{i}"))
    r1 = process_barcode(host, reads, True, RFAConfig())
    r2 = process_barcode(batch, reads, True, RFAConfig())
    for arr1, arr2 in zip(r1.alignments, r2.alignments):
        assert len(arr1) == len(arr2)
        for a1, a2 in zip(arr1, arr2):
            assert (a1.pos, a1.aend, a1.contig, a1.reversed_, a1.score,
                    a1.cigar, a1.mapq, a1.active, a1.is_proper,
                    a1.duplicate) == \
                   (a2.pos, a2.aend, a2.contig, a2.reversed_, a2.score,
                    a2.cigar, a2.mapq, a2.active, a2.is_proper, a2.duplicate)


@pytest.mark.parametrize("resident", [True, False])
def test_reg2aln_session_waves_match_host(dup_genome, monkeypatch,
                                          resident):  # noqa: F811
    """The reg2aln session's device waves (XLA global DP + device walk,
    inputs gathered on device or uploaded as buffers) match the host, and
    the engine counts every wave and its compiled shape: B pinned to the
    chunk size, lengths to the 151 bp tiers."""
    from lariat_tpu.align import native_engine
    if not native_engine.Reg2AlnSession.available():
        pytest.skip("native session unavailable")
    if not resident:
        monkeypatch.setenv("LARIAT_NO_RESIDENT", "1")
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(43)
    seqs = _reads(genome, rng, n=10)
    tasks = []
    for seq in seqs:
        for reg in host.align1(encode_read(seq)):
            tasks.append((seq, reg))
    got = batch.reg2aln_batch(tasks)
    for (seq, reg), g in zip(tasks, got):
        assert g == host.reg2aln(seq, reg), (seq, reg)
    ws = batch.wave_stats
    assert ws["r2a"] > 0 and ws["n"] == ws["r2a"]
    shapes = {s for s in batch.wave_shapes if s[0] == "r2a"}
    assert {s[1] for s in shapes} == {batch.R2ALN_CHUNK}
    assert {s[2] for s in shapes} <= {64, 192}


def test_session_path_fuzz_1k(dup_genome):  # noqa: F811
    """Device-wave candidate generation (C++ session + batched extends) must
    equal sequential host align1 on 1k random mutated reads (VERDICT r1 item
    4 'Done' criterion), and equal the Python replay path."""
    from lariat_tpu.align import native_engine
    if not native_engine.Align1Session.available():
        pytest.skip("native session unavailable")
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(97)
    seqs = _reads(genome, rng, n=1000)
    got = batch._align_batch_session(seqs)
    assert got is not None
    pyr = batch._align_batch_python(seqs)
    for i, seq in enumerate(seqs):
        want = host.align1(encode_read(seq))
        assert [dataclasses.astuple(r) for r in got[i]] == \
               [dataclasses.astuple(r) for r in want], (i, seq)
        assert [dataclasses.astuple(r) for r in pyr[i]] == \
               [dataclasses.astuple(r) for r in want], ("python-replay", i)


def test_reg2aln_session_fuzz(dup_genome):  # noqa: F811
    """reg2aln session (C++ ladder + device waves) vs sequential host on a
    few hundred messy tasks."""
    from lariat_tpu.align import native_engine
    if not native_engine.Reg2AlnSession.available():
        pytest.skip("native session unavailable")
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(113)
    seqs = _reads(genome, rng, n=150)
    tasks = []
    for seq in seqs:
        for reg in host.align1(encode_read(seq)):
            tasks.append((seq, reg))
    got = batch._reg2aln_session(tasks)
    assert got is not None
    for i, ((seq, reg), g) in enumerate(zip(tasks, got)):
        assert g == host.reg2aln(seq, reg), (i, seq)
    # pipelined multi-chunk driver: same results with tiny chunks
    batch.R2ALN_CHUNK = 37
    got2 = batch._reg2aln_session(tasks)
    batch.R2ALN_CHUNK = BatchAlignmentEngine.R2ALN_CHUNK
    assert got2 == got


def _rescue_pairs(genome, rng, n=40):
    """Pairs engineered so mate rescue actually fires: read1 clean, read2
    heavily mutated (align1 finds nothing; the local SW in the insert window
    still does)."""
    pairs = []
    for _ in range(n):
        pos = int(rng.integers(0, len(genome) - 600))
        r1 = genome[pos:pos + 100]
        frag = bytearray(genome[pos + 200:pos + 300])
        nmut = int(rng.integers(15, 35))
        for _ in range(nmut):
            p = int(rng.integers(0, len(frag)))
            frag[p] = b"ACGT"[int(rng.integers(0, 4))]
        r2 = bytes(frag).translate(COMP)[::-1]
        pairs.append((r1, r2))
        # also the symmetric case
        pairs.append((r2, r1))
    return pairs


def test_rescue_pairs_batch_matches_sequential(dup_genome):  # noqa: F811
    import copy
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    rng = np.random.default_rng(57)
    raw = _rescue_pairs(genome, rng)
    delta = 5
    seq_out = []
    batch_pairs = []
    rescued_any = 0
    for s1, s2 in raw:
        q1, q2 = encode_read(s1), encode_read(s2)
        regs1 = host.align1(q1)
        regs2 = host.align1(q2)
        b1 = copy.deepcopy(regs1)
        b2 = copy.deepcopy(regs2)
        host.finish_pair(q1, q2, regs1, regs2, delta)
        rescued_any += sum(r.rescued for r in regs1 + regs2)
        seq_out.append((regs1, regs2))
        batch_pairs.append((q1, q2, b1, b2))
    assert rescued_any > 0, "fixture failed to trigger any rescue"
    host.rescue_pairs_batch(batch_pairs, delta)
    for (r1, r2), (_, _, g1, g2) in zip(seq_out, batch_pairs):
        assert len(r1) == len(g1) and len(r2) == len(g2)
        for w, g in zip(r1 + r2, g1 + g2):
            assert dataclasses.asdict(w) == dataclasses.asdict(g)


def test_rescue_pairs_batch_device_fn_matches(dup_genome):  # noqa: F811
    """Same as above but with the batch engine's device local-SW waves
    (XLA backend on CPU) supplying the DP results."""
    import copy
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(58)
    raw = _rescue_pairs(genome, rng, n=20)
    delta = 5
    for s1, s2 in raw:
        q1, q2 = encode_read(s1), encode_read(s2)
        regs1, regs2 = host.align1(q1), host.align1(q2)
        b1, b2 = copy.deepcopy(regs1), copy.deepcopy(regs2)
        host.finish_pair(q1, q2, regs1, regs2, delta)
        batch.rescue_pairs_batch([(q1, q2, b1, b2)], delta,
                                 local_align_fn=batch.local_align_device)
        for w, g in zip(regs1 + regs2, b1 + b2):
            assert dataclasses.asdict(w) == dataclasses.asdict(g)


def test_prime_regions_with_rescue_barcode_parity(dup_genome):  # noqa: F811
    """process_barcode fed primed post-rescue regions == host path."""
    from lariat_tpu.config import RFAConfig
    from lariat_tpu.rfa.pipeline import process_barcode
    from test_rfa import _make_pair
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    reads = []
    for i, pos in enumerate(range(1500, 3100, 200)):
        reads.append(_make_pair(genome, pos, 300, f"m1:{i}"))
    cfg = RFAConfig()
    primes = batch.prime_regions(reads, cfg.chain_score_delta)
    # 5-tuples: rescue AND final-SW (reg2aln) both primed
    assert all(len(p) == 5 and p[2] for p in primes)
    assert all(len(p[3]) == len(p[0]) and len(p[4]) == len(p[1])
               for p in primes)
    r1 = process_barcode(host, reads, True, cfg)
    r2 = process_barcode(host, reads, True, cfg, primed_regions=primes)
    for arr1, arr2 in zip(r1.alignments, r2.alignments):
        assert len(arr1) == len(arr2)
        for a1, a2 in zip(arr1, arr2):
            assert (a1.pos, a1.aend, a1.contig, a1.reversed_, a1.score,
                    a1.cigar, a1.mapq, a1.active, a1.is_proper,
                    a1.duplicate) == \
                   (a2.pos, a2.aend, a2.contig, a2.reversed_, a2.score,
                    a2.cigar, a2.mapq, a2.active, a2.is_proper, a2.duplicate)


def test_session_buffer_path_matches_resident(dup_genome, monkeypatch):  # noqa: F811
    """LARIAT_NO_RESIDENT=1 (materialized wave buffers) == the default
    resident-descriptor feed, bit-for-bit."""
    import numpy as np
    from lariat_tpu.align.batch_engine import BatchAlignmentEngine
    fm, genome = dup_genome
    rng = np.random.default_rng(91)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs = []
    for i in range(20):
        ln = int(rng.integers(40, 152))
        pos = int(rng.integers(0, len(genome) - ln))
        seg = bytearray(genome[pos:pos + ln])
        for _ in range(int(rng.integers(0, 4))):
            seg[int(rng.integers(0, ln))] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            seg = bytearray(bytes(seg).translate(comp)[::-1])
        seqs.append(bytes(seg))
    eng = BatchAlignmentEngine(fm)
    res_regs = eng.align_batch(seqs)
    monkeypatch.setenv("LARIAT_NO_RESIDENT", "1")
    eng2 = BatchAlignmentEngine(fm)
    buf_regs = eng2.align_batch(seqs)
    assert len(res_regs) == len(buf_regs)
    for a, b in zip(res_regs, buf_regs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert all(getattr(x, f) == getattr(y, f)
                       for f in x.__slots__)
