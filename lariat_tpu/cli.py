"""Command-line entry point with reference flag parity (lariat/main.go:9-48).

Usage: python -m lariat_tpu.cli -reads in.fastq.gz -genome ref.fa -output dir

Accepts both single-dash (Go style) and double-dash flags.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .align.engine import AlignmentEngine
from .config import RFAConfig
from .index import fmindex
from .io.bamwriter import LariatBAMs
from .io.fastq import FastQReader
from .rfa.pipeline import (RFAStats, load_centromeres, process_barcode,
                           worth_running_rfa)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lariat_tpu", allow_abbrev=False)
    a = p.add_argument
    a("-reads", "--reads", required=True,
      help="fastq.gz input file containing reads")
    a("-improper_pair_penalty", "--improper_pair_penalty", type=float,
      default=-4.0, help="penalty for improper pair")
    a("-simulated", "--simulated", action="store_true", help="simulated data?")
    a("-output", "--output", required=True,
      help="directory at which to output bam files")
    a("-read_groups", "--read_groups",
      default="sample:library:gem_group:flowcell:lane",
      help="comma-separated list of read group IDs")
    a("-sample_id", "--sample_id", default="default_sample_id")
    a("-threads", "--threads", type=int, default=8)
    a("-max_bcs", "--max_bcs", type=int, default=-1,
      help="maximum number of barcodes to process")
    a("-debug", "--debug", action="store_true")
    a("-position_chunk_size", "--position_chunk_size", type=int,
      default=40000000)
    a("-debugBamTags", "--debugBamTags", action="store_true")
    a("-debugPrintMove", "--debugPrintMove", action="store_true")
    a("-genome", "--genome", required=True, help="genome FASTA path")
    a("-centromeres", "--centromeres", default="")
    a("-trim_length", "--trim_length", type=int, default=0)
    a("-first_chunk", "--first_chunk", action="store_true")
    a("-index", "--index", default="",
      help="optional prebuilt index prefix (.lariat.npz or bwa-format)")
    a("-profile", "--profile", default="",
      help="write a jax profiler trace to this directory (single-process "
           "mode) and print per-stage wall times")
    a("-use_device", "--use_device", choices=["auto", "on", "off"],
      default="auto",
      help="prime candidate generation (seeding, seed-extend, mate "
           "rescue, final global SW) on the accelerator. on: every pair is "
           "primed on the GPU, and the run fails without one; auto: a "
           "hybrid router uses a non-CPU backend when present and routes "
           "batches to host workers when the device falls behind; off: "
           "host workers only. Compiles persist in the JAX compile cache.")
    return p


def _prime_group(device_engine, buf, config):
    """Run one device priming pass over a group of barcodes; attach the
    per-pair candidate regions to each work item."""
    all_reads = [rec for reads, _ in buf for rec in reads]
    primes = device_engine.prime_regions(all_reads,
                                         config.chain_score_delta)
    off = 0
    out = []
    for reads, unique in buf:
        out.append((reads, unique, primes[off:off + len(reads)]))
        off += len(reads)
    return out


def load_reference(genome: str, index_prefix: str = ""):
    """Load or build the genome index: prefers our .lariat.d / .lariat.npz,
    then a bwa-format index next to the FASTA, then builds from scratch."""
    import os
    prefix = index_prefix or genome
    if os.path.isdir(prefix + ".lariat.d"):
        return fmindex.FMIndex.load_dir(prefix)
    if os.path.exists(prefix + ".lariat.npz"):
        return fmindex.FMIndex.load(prefix)
    if os.path.exists(prefix + ".bwt"):
        return fmindex.load_bwa_index(prefix)
    fm = fmindex.build_index(genome)
    try:
        fm.save(genome)
    except OSError:
        pass
    return fm


def main(argv=None) -> int:
    rc, _ = run(argv)
    return rc


def _cpu_pinned() -> bool:
    plat = os.environ.get("JAX_PLATFORMS", "")
    return bool(plat) and set(plat.split(",")) <= {"cpu"}


def _device_engine(use_device: str, fm):
    """The device priming engine, or None for host-only workers.

    ``on`` means the card: it raises unless JAX's backend is a GPU, except
    under an explicit JAX_PLATFORMS=cpu pin (tests drive the same priming
    path on the CPU backend). ``auto`` primes on any accelerator backend
    and runs host-only workers otherwise. Must run after the worker pool
    has forked: initialising the backend starts JAX's threads and, on a
    GPU, a CUDA context, neither of which may exist in the parent at fork.
    """
    if use_device == "off" or (use_device == "auto" and _cpu_pinned()):
        return None
    import jax
    if use_device == "on":
        backend = jax.default_backend()
        if backend != "gpu" and not _cpu_pinned():
            raise RuntimeError(
                f"-use_device on needs a GPU, but JAX's backend is "
                f"{backend!r} (pin JAX_PLATFORMS=cpu to run the priming "
                f"path on the CPU)")
    else:
        try:
            backend = jax.default_backend()
        except RuntimeError as e:  # no usable backend at all
            print(f"device priming unavailable ({e}); host-only workers")
            return None
        if backend == "cpu":
            return None
    from .align.batch_engine import BatchAlignmentEngine
    engine = BatchAlignmentEngine(fm)
    dev = jax.devices()[0]
    print(f"device priming on {dev} ({dev.platform}, {dev.device_kind})")
    return engine


def run(argv=None):
    """Full pipeline; returns (exit_code, RFAStats) so multi-host drivers can
    psum the stats across processes (parallel/multihost.py)."""
    args = build_parser().parse_args(argv)
    if args.use_device == "on" and args.threads < 2:
        raise SystemExit("-use_device on primes on the device for the "
                         "worker pool: it needs -threads >= 2")
    if args.debugPrintMove or args.debug:
        # set before workers fork so every process inherits the switches
        from .rfa import debug as rfa_debug
        rfa_debug.PRINT_MOVE = rfa_debug.PRINT_MOVE or args.debugPrintMove
        rfa_debug.DEBUG = rfa_debug.DEBUG or args.debug
    print(f"Starting lariat_tpu. Version: {__version__}")
    print(f"Loading reference genome: {args.genome}")
    fm = load_reference(args.genome, args.index)
    print("Reference loaded")
    if fm.l_pac > fmindex.FMIndex.CODES_CACHE_MAX:
        # genomes past the auto-cache bound (hg38-scale) still want the
        # unpacked-codes cache; build it pre-fork so workers share it CoW
        fm.ensure_codes_cache()
    # hugepage-migrate the FM hot arrays pre-fork (no-op for small genomes)
    fm.ensure_native_hot()
    engine = AlignmentEngine(fm)
    config = RFAConfig(improper_pair_penalty=args.improper_pair_penalty)
    centromeres = load_centromeres(args.centromeres or None)
    stats = RFAStats()
    bams = LariatBAMs(
        contigs=[(c.name, c.length) for c in fm.contigs],
        base_path=args.output, read_groups=args.read_groups,
        sample_id=args.sample_id,
        position_chunk_size=args.position_chunk_size,
        debug_tags=args.debugBamTags, first_chunk=args.first_chunk,
        version=__version__, cl=" ".join(sys.argv))
    reader = FastQReader(args.reads)
    t0 = time.time()

    def work_iter():
        barcode_num = 0
        while True:
            barcode_num += 1
            reads, unique = reader.read_barcode_set(args.trim_length)
            if reads is None:
                return
            if barcode_num == args.max_bcs:
                return
            if len(reads) > 2:
                print(f"working on barcode {reads[0].barcode10x.decode()}  "
                      f"num reads: {len(reads)}  doing RFA: "
                      f"{worth_running_rfa(reads, unique)}  "
                      f"unique_barcode {unique}")
            yield reads, unique

    n_pairs = 0
    n_bcs = 0
    if args.threads > 1:
        # worker pool over barcode groups (reference lariat.go:333-390);
        # with a device available, candidate-generation DP is primed on it in
        # the main process and workers run rescue + RFA + emission
        from .parallel.host_pipeline import ParallelRunner, write_packed
        # fork the worker pool BEFORE any jax initialization: jax spawns
        # threads and fork-after-threads deadlocks
        runner = ParallelRunner(engine, config, centromeres, bams.tid,
                                args.debugBamTags, args.simulated,
                                args.threads,
                                position_chunk_size=args.position_chunk_size)
        try:
            device_engine = _device_engine(args.use_device, fm)
        except BaseException:
            runner.close()
            raise
        strict = args.use_device == "on"
        feed_stats = {"primed_pairs": 0, "host_pairs": 0}

        def primed_iter():
            """Tagged work feed: yields (seq, work), possibly out of reader
            order (the main loop reorders results by seq before writing).

            Barcode groups batch up to a few thousand pairs, and each batch
            is primed on the device by one of LARIAT_PRIME_THREADS priming
            threads. Under ``-use_device on`` every batch is primed: when
            all threads are busy the feed waits for the oldest. Under
            ``auto`` (the hybrid router) a batch goes to the host workers,
            who run the native DP themselves, when priming is saturated or
            the device cannot keep up, and batches still queued at EOF are
            host-routed too."""
            import itertools
            seq = itertools.count()
            if device_engine is None:
                for item in work_iter():
                    yield (next(seq), item)
                return
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            n_prime = max(1, int(os.environ.get("LARIAT_PRIME_THREADS",
                                                "2")))
            ex = ThreadPoolExecutor(max_workers=n_prime,
                                    thread_name_prefix="lariat-prime")
            rate_box = {"pairs_s": None}

            def prime_tagged(tagged):
                t_p = time.time()
                primed = _prime_group(device_engine,
                                      [it for _, it in tagged], config)
                dt = max(time.time() - t_p, 1e-3)
                n = sum(len(it[0]) for _, it in tagged)
                r = n / dt
                prev = rate_box["pairs_s"]
                rate_box["pairs_s"] = r if prev is None else (
                    0.5 * prev + 0.5 * r)
                return [(s, p) for (s, _), p in zip(tagged, primed)]

            futs = deque()   # (future, tagged) pairs
            dorm = {"first_submit": None, "off": False}

            def dormant() -> bool:
                """(auto only) Give up on priming for the rest of the run
                when the device cannot pull its weight: it must add >=
                LARIAT_PRIME_MIN_FRAC (default 15%) on top of the host
                pool's concurrent throughput, or complete a batch within
                45 s."""
                if dorm["off"]:
                    return True
                r = rate_box["pairs_s"]
                el = time.time() - t0
                if r is None:
                    fs = dorm["first_submit"]
                    if fs is not None and time.time() - fs > 45.0:
                        dorm["off"] = True
                else:
                    host_rate = feed_stats["host_pairs"] / max(el, 1e-3)
                    frac = float(os.environ.get("LARIAT_PRIME_MIN_FRAC",
                                                "0.15"))
                    if r < frac * host_rate:
                        dorm["off"] = True
                if dorm["off"]:
                    print(f"device priming dormant (measured "
                          f"{r or 0:.0f} pairs/s)", flush=True)
                return dorm["off"]

            def batch_target() -> int:
                # size prime batches so one batch is ~2 s of device work;
                # until the first batch lands the rate is unknown, so start
                # small (the first batch carries the compiles)
                r = rate_box["pairs_s"]
                if r is None:
                    return 1024
                return max(512, min(16384, int(r * 2.0)))

            def busy() -> int:
                return sum(1 for f, _ in futs if not f.done())

            def host_route(buf):
                for s, it in buf:
                    feed_stats["host_pairs"] += len(it[0])
                    yield (s, it)

            def take_oldest():
                f, _ = futs.popleft()
                for t in f.result():
                    feed_stats["primed_pairs"] += len(t[1][0])
                    yield t

            def drain(block: bool):
                while futs and (block or futs[0][0].done()):
                    yield from take_oldest()

            def submit(buf):
                if strict:
                    while busy() >= n_prime:
                        # wait for the oldest batch to free a slot
                        yield from take_oldest()
                elif dormant() or busy() >= n_prime:
                    yield from host_route(buf)
                    return
                if dorm["first_submit"] is None:
                    dorm["first_submit"] = time.time()
                futs.append((ex.submit(prime_tagged, buf), buf))

            try:
                buf = []
                pending = 0
                for item in work_iter():
                    buf.append((next(seq), item))
                    pending += len(item[0])
                    if pending >= batch_target():
                        yield from submit(buf)
                        buf = []
                        pending = 0
                        yield from drain(block=False)
                if buf:
                    yield from submit(buf)
                if not strict:
                    # EOF: batches still queued behind a busy device go to
                    # the host workers instead of waiting
                    keep = deque()
                    while futs:
                        f, tagged = futs.popleft()
                        if f.cancel():
                            yield from host_route(tagged)
                        else:
                            keep.append((f, tagged))
                    futs = keep
                yield from drain(block=True)
            finally:
                ex.shutdown(wait=True, cancel_futures=True)

        reorder = {}
        next_seq = 0
        for seq_i, packed in runner.imap_seq(primed_iter()):
            reorder[seq_i] = packed
            while next_seq in reorder:
                packed = reorder.pop(next_seq)
                next_seq += 1
                write_packed(bams, packed)
                n_pairs += packed.n_reads
                n_bcs += 1
                stats.total += packed.stats[0]
                stats.correct += packed.stats[1]
                stats.total_mapq10 += packed.stats[2]
                stats.correct_mapq10 += packed.stats[3]
                if len(packed.stats) >= 6:
                    stats.picks += packed.stats[4]
                    stats.tie_picks += packed.stats[5]
                if len(packed.stats) >= 7:
                    stats.rfa_wall += packed.stats[6]
        assert not reorder, "reorder buffer not drained"
        runner.close()
    else:
        profiler = None
        if args.profile:
            try:
                import jax
                jax.profiler.start_trace(args.profile)
                profiler = jax
            except Exception as e:
                print(f"profiler unavailable: {e}")
        t_align = t_dump = 0.0
        for reads, unique in work_iter():
            t1 = time.time()
            result = process_barcode(engine, reads, unique, config,
                                     centromeres, stats, args.simulated)
            t2 = time.time()
            bams.dump(result.alignments, result.attach_bx)
            t_align += t2 - t1
            t_dump += time.time() - t2
            n_pairs += len(reads)
            n_bcs += 1
        if profiler is not None:
            profiler.profiler.stop_trace()
        if args.profile:
            print(f"stage times: align+rfa {t_align:.2f}s, emit {t_dump:.2f}s")
    bams.close()
    dt = time.time() - t0
    if args.threads > 1 and device_engine is not None:
        ws = device_engine.wave_stats
        print(f"device waves: {ws['n']} (seed {ws['seed']} ext {ws['ext']} "
              f"loc {ws['loc']} r2a {ws['r2a']})  "
              f"wave shapes {len(device_engine.wave_shapes)}  "
              f"wave wall {ws['wall']:.1f}s  "
              f"busy fraction {min(ws['wall'] / max(dt, 1e-9), 1.0):.2f}  "
              f"primed pairs {feed_stats['primed_pairs']}  "
              f"host pairs {feed_stats['host_pairs']}")
    print(f"Processed {n_pairs} read pairs across {n_bcs} barcodes "
          f"in {dt:.1f}s ({n_pairs / max(dt, 1e-9):.1f} pairs/s)")
    if stats.picks:
        print(f"tie-sensitive picks: {stats.tie_picks}/{stats.picks} "
              f"({stats.tie_picks / stats.picks:.4f})")
    if stats.rfa_wall:
        jit_on = os.environ.get("LARIAT_RFA_JIT") not in (None, "", "0")
        print(f"rfa wall: {stats.rfa_wall:.2f}s across workers "
              f"(rows: {'jit' if jit_on else 'numpy'})")
    if args.simulated and stats.total:
        print(f"simulated: total={stats.total} correct={stats.correct} "
              f"mapq10 total={stats.total_mapq10} correct={stats.correct_mapq10}")
    print("Lariat completed successfully")
    return 0, stats


if __name__ == "__main__":
    sys.exit(main())
