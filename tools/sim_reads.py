"""Simulate barcoded 10X-style linked reads from a FASTA genome.

Molecule-structured: each barcode carries a few long molecules (~50 kb),
each molecule sheds read pairs at random positions — the structure RFA
exploits (reference lariat.go molecule model). Truth is encoded in the
qname in the reference's colon format (lariat.go:517-542 /
go/check.py): parts[5] = read1 truth pos, parts[6] = read2 truth pos
(contig-relative), so `-simulated` accounting and tools/check.py work.

    python tools/sim_reads.py data_big/hg38sim.fa out.fastq.gz \
        --barcodes 200 --pairs-per-bc 50

Records are barcode-grouped (the reader's contract) in the 9-line format.
``--indel-frac`` gives that fraction of read 1s a 1-4 bp deletion or
insertion (so the reg2aln global DP has gapped work), and
``--improper-frac`` places that fraction of read 2s on the same strand
500-1500 bp away (improper pairs, so mate rescue runs).
"""

from __future__ import annotations

import argparse
import gzip
import sys

import numpy as np

COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
BC_BASES = b"ACGT"


def load_fasta(path: str):
    contigs = []  # (name, bytes)
    name = None
    parts = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    contigs.append((name, b"".join(parts)))
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line.strip())
    if name is not None:
        contigs.append((name, b"".join(parts)))
    return contigs


def make_barcode(rng, i: int) -> bytes:
    # unique 14-mer: 7 random bases + 7 bases encoding i
    tail = []
    v = i
    for _ in range(7):
        tail.append(BC_BASES[v & 3])
        v >>= 2
    head = bytes(BC_BASES[c] for c in rng.integers(0, 4, 7))
    return head + bytes(tail)


def mutate(rng, seq: bytearray, rate: float) -> None:
    n = rng.binomial(len(seq), rate)
    for p in rng.integers(0, len(seq), n):
        seq[p] = BC_BASES[int(rng.integers(0, 4))]


def indel_read(rng, cseq: bytes, pos: int, L: int) -> bytearray:
    """Read of length L at pos carrying one 1-4 bp deletion or insertion
    at least 20 bp from either end."""
    cut = int(rng.integers(20, L - 20))
    n = int(rng.integers(1, 5))
    if rng.integers(0, 2):
        return bytearray(cseq[pos:pos + cut] + cseq[pos + cut + n:pos + L + n])
    ins = bytes(BC_BASES[int(c)] for c in rng.integers(0, 4, n))
    return bytearray(cseq[pos:pos + cut] + ins + cseq[pos + cut:pos + L - n])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("fasta")
    p.add_argument("output", help="output .fastq.gz (or .fastq)")
    p.add_argument("--barcodes", type=int, default=200)
    p.add_argument("--pairs-per-bc", type=int, default=50)
    p.add_argument("--molecules-per-bc", type=int, default=4)
    p.add_argument("--molecule-len", type=int, default=50000)
    p.add_argument("--read-len", type=int, default=151)
    p.add_argument("--insert", type=int, default=300)
    p.add_argument("--error-rate", type=float, default=0.003)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--indel-frac", type=float, default=0.0)
    p.add_argument("--improper-frac", type=float, default=0.0)
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    contigs = load_fasta(args.fasta)
    lens = np.array([len(s) for _, s in contigs], dtype=np.float64)
    cprob = lens / lens.sum()
    L, ins = args.read_len, args.insert
    opener = gzip.open if args.output.endswith(".gz") else open
    n_out = 0
    with opener(args.output, "wt") as f:
        for b in range(args.barcodes):
            bc = make_barcode(rng, b).decode()
            mols = []
            for m in range(args.molecules_per_bc):
                ci = int(rng.choice(len(contigs), p=cprob))
                cname, cseq = contigs[ci]
                mlen = min(args.molecule_len, len(cseq) - ins - 1)
                start = int(rng.integers(0, len(cseq) - mlen - ins))
                mols.append((cname, cseq, start, mlen))
            per = np.full(len(mols), args.pairs_per_bc // len(mols))
            per[:args.pairs_per_bc % len(mols)] += 1
            recs = []
            for mi, ((cname, cseq, start, mlen), k) in enumerate(
                    zip(mols, per)):
                for i in range(int(k)):
                    pos = start + int(rng.integers(0, mlen))
                    r1 = bytearray(cseq[pos:pos + L])
                    if args.indel_frac and rng.random() < args.indel_frac:
                        r1 = indel_read(rng, cseq, pos, L)
                    p2 = pos + ins - L
                    improper = (args.improper_frac
                                and rng.random() < args.improper_frac)
                    if improper:
                        p2 = min(pos + int(rng.integers(500, 1500)),
                                 len(cseq) - L)
                    r2 = bytearray(cseq[p2:p2 + L])
                    mutate(rng, r1, args.error_rate)
                    mutate(rng, r2, args.error_rate)
                    if not improper:
                        r2 = bytes(r2).translate(COMP)[::-1]
                    # truth qname: parts[5]=read1 pos, parts[6]=read2 pos
                    qname = f"sim:{bc}:{cname}:{mi}:{i}:{pos}:{p2}"
                    recs.append((qname, bytes(r1), r2))
            for qname, r1, r2 in recs:
                f.write(f"@{qname} rg\n{r1.decode()}\n{'I' * len(r1)}\n"
                        f"{r2.decode()}\n{'I' * len(r2)}\n"
                        f"{bc}-1,{bc}\n{'J' * 14}\nACGTACGT\nIIIIIIII\n")
                n_out += 1
    print(f"wrote {n_out} pairs / {args.barcodes} barcodes -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
