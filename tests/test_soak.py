"""Soak/differential hardening: messy inputs through the full stack.

Pushes reads with indels, Ns, chimeric joins, homopolymers, and junk through
(a) the batch-vs-sequential engine differential and (b) the complete
per-barcode RFA pipeline, asserting bit-identity and no crashes. The regular
suite runs a small sample; RUN_SLOW=1 multiplies the load.
"""

import dataclasses
import os

import numpy as np
import pytest

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.align.engine import AlignmentEngine, encode_read
from lariat_tpu.config import RFAConfig
from lariat_tpu.io.fastq import FastQRecord
from lariat_tpu.rfa.pipeline import process_barcode

from test_rfa import dup_genome  # noqa: F401

COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
N_ROUNDS = 8 if os.environ.get("RUN_SLOW") else 2


def _messy_read(genome, rng):
    """A deliberately ugly read: indels, N runs, chimera, junk, homopolymer."""
    kind = int(rng.integers(0, 8))
    glen = len(genome)
    ln = int(rng.integers(40, 152))
    pos = int(rng.integers(0, glen - 400))
    seq = bytearray(genome[pos:pos + ln])
    if kind == 0:          # clean + substitutions
        for _ in range(int(rng.integers(0, 8))):
            seq[int(rng.integers(0, len(seq)))] = b"ACGT"[
                int(rng.integers(0, 4))]
    elif kind == 1:        # insertion block
        at = int(rng.integers(1, len(seq)))
        ins = bytes(b"ACGT"[int(rng.integers(0, 4))]
                    for _ in range(int(rng.integers(1, 12))))
        seq = seq[:at] + bytearray(ins) + seq[at:]
    elif kind == 2:        # deletion (take a gapped slice of the genome)
        gap = int(rng.integers(1, 15))
        seq = bytearray(genome[pos:pos + ln // 2]
                        + genome[pos + ln // 2 + gap:pos + ln + gap])
    elif kind == 3:        # N runs
        at = int(rng.integers(0, max(1, len(seq) - 5)))
        seq[at:at + int(rng.integers(1, 6))] = b"N" * int(rng.integers(1, 6))
    elif kind == 4:        # chimera of two distant loci
        pos2 = int(rng.integers(0, glen - 200))
        seq = bytearray(genome[pos:pos + ln // 2]
                        + genome[pos2:pos2 + ln - ln // 2])
    elif kind == 5:        # homopolymer-heavy
        seq = bytearray(b"A" * int(rng.integers(20, 80))) + seq[:40]
    elif kind == 6:        # pure junk
        seq = bytearray(bytes(b"ACGT"[int(rng.integers(0, 4))]
                              for _ in range(ln)))
    else:                  # very short
        seq = seq[:int(rng.integers(1, 25))]
    if rng.integers(0, 2):
        seq = bytearray(bytes(seq).translate(COMP)[::-1])
    return bytes(seq)


@pytest.mark.parametrize("round_", range(N_ROUNDS))
def test_messy_batch_matches_host(dup_genome, round_):  # noqa: F811
    fm, genome = dup_genome
    host = AlignmentEngine(fm)
    batch = BatchAlignmentEngine(fm)
    rng = np.random.default_rng(round_ * 977 + 5)
    seqs = [_messy_read(genome, rng) for _ in range(20)]
    got_all = batch.align_batch(seqs)
    for seq, got in zip(seqs, got_all):
        want = host.align1(encode_read(seq))
        assert len(got) == len(want), seq
        for g, w in zip(got, want):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), seq


@pytest.mark.parametrize("round_", range(N_ROUNDS))
def test_messy_full_pipeline(dup_genome, round_):  # noqa: F811
    """Full RFA pipeline over messy pairs: must complete, and every read
    must come back exactly once with sane fields."""
    fm, genome = dup_genome
    engine = AlignmentEngine(fm)
    rng = np.random.default_rng(round_ * 31 + 11)
    recs = []
    for i in range(24):
        r1 = _messy_read(genome, rng)
        r2 = _messy_read(genome, rng)
        q1 = b"I" * len(r1)
        q2 = b"I" * len(r2)
        recs.append(FastQRecord(
            read1=r1, read_qual1=q1, read2=r2, read_qual2=q2,
            barcode10x=b"ACGTACGTACGTAA-1", barcode10x_qual=b"J" * 14,
            raw_barcode10x=b"ACGTACGTACGTAA", barcode=b"ACGTACGT",
            barcode_qual=b"IIIIIIII", read_info=f"soak:{round_}:{i}"))
    result = process_barcode(engine, recs, True, RFAConfig())
    # the BAM writer requires exactly one active alignment per read
    assert len(result.alignments) == 2 * len(recs)
    for read_id, lst in enumerate(result.alignments):
        assert lst, read_id
        active = [a for a in lst if a.active]
        assert len(active) == 1, (read_id, len(active))
        assert 0 <= active[0].mapq <= 60, (read_id, active[0].mapq)
