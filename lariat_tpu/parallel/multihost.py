"""Multi-host scale-out driver: one CLI process per host, over the network.

Scale-out design (SURVEY.md sections 2.3/5; reference contract is the outer
chunked invocation: ``-max_bcs``/``-first_chunk`` + position-bucketed BAMs
merged downstream, lariat/main.go:16,18,24):

 - INPUT: each host consumes its own barcode-complete FASTQ shard (barcode
   atomicity preserved by splitting at barcode boundaries, exactly like the
   reference's Long Ranger chunking). No read ever crosses hosts.
 - INDEX: the genome index is replicated per host (hg38 FMD arrays ~6 GB:
   fits device HBM and trivially host RAM), so alignment needs NO inter-host
   communication — the same decision as the reference's per-process in-RAM
   bwa index.
 - COMPUTE: within a host, the device batch waves run on the local chips via
   a 1-D data mesh (see __graft_entry__.dryrun_multichip); RFA/emission run
   on host workers.
 - OUTPUT: each host writes its own first_chunk-gated BAM set; the
   position-bucket naming makes the global merge a deterministic
   concatenation (tools/cat_bams.py --auto host0_out host1_out ...).
 - STATS: summed with a single psum over the global mesh at the end.

This module wires those pieces; it degenerates to the single-host pipeline
when ``num_processes == 1`` (which is how it is tested here — multi-host
hardware is exercised by the driver's mesh dry run).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class HostShardPlan:
    """Which inputs/outputs this host owns."""
    host_id: int
    num_hosts: int
    reads_path: str
    output_dir: str
    first_chunk: bool     # only host 0 of chunk 0 writes the @CO headers


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0) -> bool:
    """jax.distributed bring-up; no-op for a single process.

    Returns True when the distributed service is (now) up.  When the local
    jax backend was already initialized before this call — which happens when
    the pipeline ran with ``use_device != off`` (device priming touches the
    backend) — ``jax.distributed.initialize`` raises; we degrade to
    local-only stats instead of crashing a run whose alignment work has
    already completed successfully.
    """
    if num_processes <= 1:
        return False
    import sys
    import jax
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return True
    except RuntimeError as e:
        print(f"lariat_tpu.multihost: jax.distributed unavailable ({e}); "
              "reporting local stats only", file=sys.stderr)
        return False


def plan_host_shards(reads_paths: List[str], output_base: str,
                     num_hosts: int) -> List[HostShardPlan]:
    """Round-robin barcode-complete FASTQ shards over hosts.

    ``reads_paths`` must each be barcode-complete (produced by an upstream
    barcode-aware splitter, as in the reference's pipeline contract).
    """
    plans = []
    for h in range(num_hosts):
        mine = [p for i, p in enumerate(reads_paths) if i % num_hosts == h]
        if not mine:
            continue
        plans.append(HostShardPlan(
            host_id=h, num_hosts=num_hosts, reads_path=mine[0],
            output_dir=f"{output_base}/host{h:03d}",
            first_chunk=(h == 0)))
    return plans


def global_stats_psum(local_stats) -> list:
    """Sum RFAStats across hosts with one collective over the global mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    vals = jnp.asarray(np.array([local_stats.total, local_stats.correct,
                                 local_stats.total_mapq10,
                                 local_stats.correct_mapq10],
                                dtype=np.int64))
    if jax.process_count() == 1:
        return [int(v) for v in vals]
    from jax.experimental import multihost_utils
    summed = multihost_utils.process_allgather(vals).sum(axis=0)
    return [int(v) for v in summed]


def run_host(plan: HostShardPlan, genome: str, threads: int = 8,
             use_device: str = "off", extra_args: Optional[List[str]] = None):
    """Run this host's shard through the standard CLI pipeline.

    Returns (exit_code, RFAStats) so the caller can psum stats globally."""
    from ..cli import run as cli_run
    argv = ["-reads", plan.reads_path, "-genome", genome,
            "-output", plan.output_dir, "-threads", str(threads),
            "-use_device", use_device]
    if plan.first_chunk:
        argv.append("-first_chunk")
    if extra_args:
        argv.extend(extra_args)
    return cli_run(argv)


def main(argv=None) -> int:
    """Per-process entry point for a real multi-host run:

        python -m lariat_tpu.parallel.multihost \\
            -coordinator host0:29500 -num_processes N -process_id i \\
            -reads shard_i.fastq.gz -genome ref.fa -output_base out ...

    Runs this host's shard through the standard pipeline (workers fork before
    any jax initialization), THEN brings up jax.distributed and psums the
    stats — so the collective never races the fork pool. Prints one JSON line
    with the globally-summed stats; host outputs merge downstream with
    tools/cat_bams.py --auto (reference contract: chunked invocation,
    lariat/main.go:16,24 + bucket merge bamwriter.go:133-191).
    """
    import argparse
    import json

    p = argparse.ArgumentParser(prog="lariat_tpu.multihost")
    p.add_argument("-coordinator", "--coordinator", default=None,
                   help="coordinator address host:port (process 0 serves)")
    p.add_argument("-num_processes", "--num_processes", type=int, default=1)
    p.add_argument("-process_id", "--process_id", type=int, default=0)
    p.add_argument("-reads", "--reads", required=True,
                   help="this host's barcode-complete FASTQ shard")
    p.add_argument("-genome", "--genome", required=True)
    p.add_argument("-output_base", "--output_base", required=True)
    p.add_argument("-threads", "--threads", type=int, default=8)
    p.add_argument("-use_device", "--use_device", default="off")
    p.add_argument("-jax_platform", "--jax_platform", default="",
                   help="force a jax platform (tests: 'cpu')")
    args, extra = p.parse_known_args(argv)

    if args.jax_platform:
        import jax
        jax.config.update("jax_platforms", args.jax_platform)

    plan = HostShardPlan(
        host_id=args.process_id, num_hosts=args.num_processes,
        reads_path=args.reads,
        output_dir=f"{args.output_base}/host{args.process_id:03d}",
        first_chunk=(args.process_id == 0))
    rc, stats = run_host(plan, args.genome, threads=args.threads,
                         use_device=args.use_device, extra_args=extra)
    local = [stats.total, stats.correct, stats.total_mapq10,
             stats.correct_mapq10]
    if init_distributed(args.coordinator, args.num_processes,
                        args.process_id):
        summed = global_stats_psum(stats)
    else:
        summed = list(local)
    print(json.dumps({"host": args.process_id, "rc": rc,
                      "output_dir": plan.output_dir,
                      "local_stats": local,
                      "global_stats": summed}))
    return rc


if __name__ == "__main__":
    import sys
    sys.exit(main())
