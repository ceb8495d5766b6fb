"""Profile the device-priming stages over one group of read pairs.

Usage:
    PYTHONPATH=/root/repo:$PYTHONPATH python tools/prime_profile.py \
        <genome.fa> <reads.fastq.gz> [n_pairs]

Prints per-stage wall times for the priming path the CLI runs in its main
process (seeding -> align1 session waves -> device mate rescue), plus wave
counts, so regressions in any stage are attributable.
"""

import sys
import time

import numpy as np


def main() -> None:
    genome, reads_path = sys.argv[1], sys.argv[2]
    n_pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 2000

    from lariat_tpu.cli import load_reference
    from lariat_tpu.config import RFAConfig
    from lariat_tpu.io.fastq import FastQReader

    t0 = time.time()
    fm = load_reference(genome)
    print(f"index load: {time.time() - t0:.1f}s")

    reader = FastQReader(reads_path)
    recs = []
    while len(recs) < n_pairs:
        reads, _ = reader.read_barcode_set(0)
        if reads is None:
            break
        recs.extend(reads)
    print(f"pairs: {len(recs)}")
    config = RFAConfig()

    import jax

    from lariat_tpu.align.batch_engine import BatchAlignmentEngine
    from lariat_tpu.align.engine import encode_read
    from lariat_tpu.index import native_ops

    eng = BatchAlignmentEngine(fm)
    print(f"backend: {jax.default_backend()}")

    seqs = []
    for rec in recs:
        seqs.append(rec.read1)
        seqs.append(rec.read2)
    qs = [encode_read(s) for s in seqs]

    t0 = time.time()
    native_ops.collect_seeds_rbegs_batch(fm, [q for q in qs if len(q)],
                                         eng.opt)
    t_seed = time.time() - t0
    print(f"seeding (host C++): {t_seed:.2f}s")

    # first align_batch includes the jit compiles (cached across runs)
    t0 = time.time()
    regs = eng.align_batch(seqs)
    t_align = time.time() - t0
    print(f"align_batch (session + device waves): {t_align:.2f}s")

    pairs = [(encode_read(r.read1), encode_read(r.read2),
              regs[2 * i], regs[2 * i + 1]) for i, r in enumerate(recs)]
    t0 = time.time()
    eng.rescue_pairs_batch(pairs, config.chain_score_delta,
                           local_align_fn=eng.local_align_device)
    t_rescue = time.time() - t0
    print(f"rescue (device local SW): {t_rescue:.2f}s")

    total = t_seed + t_align + t_rescue
    print(f"total: {total:.2f}s = {len(recs) / total:.1f} pairs/s priming")


if __name__ == "__main__":
    main()
