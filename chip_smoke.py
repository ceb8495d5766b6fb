#!/usr/bin/env python3
"""Smoke test of the aligner's device path on an NVIDIA GPU.

    python chip_smoke.py [--seed 7] [--data DIR] [--log-dir DIR]

Phases; any failure exits non-zero and prints no result line:

 1. Environment: JAX's version and devices (its backend must be ``gpu``),
    the card's name and power limit from nvidia-smi, and the native library
    built from ``native/`` (the host reference needs it).
 2. Inputs from ``--seed``: a repeat-structured ~64 Mbp genome
    (tools/synth_genome.py --scale 0.0208, a chr20-sized cut of hg38) and
    its index, built once into ``--data`` and reused; 1,000 barcodes x 50
    pairs of 151 bp linked reads (tools/sim_reads.py), a quarter of them
    with a small indel and a tenth with broken mate geometry, so the
    reg2aln global and mate-rescue waves have work.
 3. Kernel parity on the card at real widths, each bit-identical to the
    native host reference (integer DP: no tolerance): an extend wave, a
    reg2aln wave with the device traceback walk, a mate-rescue local
    two-pass wave, and device SMEM seeding against the genome's index.
 4. End to end through the CLI: ``-use_device on`` with device seeding
    forced (every pair must be primed on the card, none host-routed, and
    every wave kind must run), then ``-use_device off``; the decoded
    records of every output BAM must be identical.

The last line of stdout is ``{"ok": true, "device": {...}}``. This process
never imports JAX: the JAX phases and the two CLI runs are child processes
that run one after another, so one process at a time holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_SCALE = 0.0208          # ~64 Mbp: tools/gen_data_big.py's chr20sim
N_BARCODES = 1000
PAIRS_PER_BC = 50
INDEL_FRAC = 0.25
IMPROPER_FRAC = 0.10
EXT_B = 16384                  # extend wave tasks
R2A_B = 2048                   # reg2aln wave (BatchAlignmentEngine chunk)
LOC_B = 2048                   # mate-rescue local wave tasks
SEED_READS = 2048              # reads seeded on the device
REPS = 5                       # timed repetitions per kernel wave
CLI_THREADS = 8                # CLI worker processes (-threads)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def _child(argv, what: str, timeout: float, env=None, log=None) -> str:
    """Run a child process to its end; echo its output (or keep it in
    ``log`` when it is long) and raise unless it exited 0."""
    t0 = time.time()
    p = subprocess.run(argv, cwd=REPO, env=env or _env(), text=True,
                       capture_output=True, timeout=timeout)
    if log:
        with open(log, "w") as f:
            f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    else:
        sys.stdout.write(p.stdout)
    sys.stdout.flush()
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-6000:])
        raise SystemExit(f"{what} failed (exit code {p.returncode}) after "
                         f"{time.time() - t0:.1f} s")
    return p.stdout


# ------------------------------------------------------------------ inputs

def make_inputs(data: str, seed: int, scale: float = GENOME_SCALE,
                barcodes: int = N_BARCODES,
                pairs_per_bc: int = PAIRS_PER_BC):
    """Genome FASTA + index and the read FASTQ for ``seed``; each is made
    once and reused. Returns (fasta, fastq, seconds spent building)."""
    os.makedirs(data, exist_ok=True)
    t0 = time.time()
    fa = os.path.join(data, f"genome_s{seed}_x{scale}.fa")
    if not os.path.isdir(fa + ".lariat.d"):
        subprocess.run([sys.executable, "tools/synth_genome.py", fa,
                        "--scale", str(scale), "--seed", str(seed)],
                       cwd=REPO, env=_env(), check=True,
                       stdout=subprocess.DEVNULL)
        sys.path.insert(0, REPO)
        from lariat_tpu.index import fmindex
        fm = fmindex.build_index(fa)
        fm.save_dir(fa)
    fq = os.path.join(data, f"reads_s{seed}_x{scale}_{barcodes}x"
                            f"{pairs_per_bc}.fastq.gz")
    if not os.path.exists(fq):
        tmp = fq + ".part.fastq.gz"
        subprocess.run([sys.executable, "tools/sim_reads.py", fa, tmp,
                        "--barcodes", str(barcodes),
                        "--pairs-per-bc", str(pairs_per_bc),
                        "--indel-frac", str(INDEL_FRAC),
                        "--improper-frac", str(IMPROPER_FRAC),
                        "--seed", str(seed)],
                       cwd=REPO, env=_env(), check=True,
                       stdout=subprocess.DEVNULL)
        os.replace(tmp, fq)
    return fa, fq, time.time() - t0


# -------------------------------------------------------------- BAM parity

def bam_records(out_dir: str) -> dict:
    """{file name: decoded records} for every BAM in a CLI output dir."""
    sys.path.insert(0, REPO)
    from lariat_tpu.io.bamread import BamFile
    return {name: list(BamFile(os.path.join(out_dir, name)))
            for name in sorted(os.listdir(out_dir)) if name.endswith(".bam")}


def compare_bams(dir_a: str, dir_b: str) -> int:
    """Raise unless both dirs hold the same BAMs with identical decoded
    records (the @PG header line differs with the command line, so only
    records are compared); returns the record count."""
    a, b = bam_records(dir_a), bam_records(dir_b)
    if sorted(a) != sorted(b):
        raise AssertionError(f"BAM sets differ: {sorted(a)} vs {sorted(b)}")
    n = 0
    for name in a:
        if len(a[name]) != len(b[name]):
            raise AssertionError(f"{name}: {len(a[name])} vs "
                                 f"{len(b[name])} records")
        for i, (ra, rb) in enumerate(zip(a[name], b[name])):
            if ra != rb:
                raise AssertionError(f"{name}: record {i} differs:\n"
                                     f"  {ra}\n  {rb}")
        n += len(a[name])
    if n == 0:
        raise AssertionError("no BAM records at all")
    return n


# ------------------------------------------------------------ JAX phases

def phase_env() -> None:
    import jax
    print(f"jax {jax.__version__}; devices {jax.devices()}")
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"JAX backend is {backend!r}, not 'gpu': "
                         f"no accelerator to test")
    d = jax.devices()[0]
    print("DEVICE " + json.dumps({"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(jax.devices())}))


def _timed(fn):
    """(first-call seconds incl. compile, median of REPS warm calls, last
    result). ``fn`` must block until its result is on the host."""
    t0 = time.time()
    out = fn()
    first = time.time() - t0
    times = []
    for _ in range(REPS):
        t0 = time.time()
        out = fn()
        times.append(time.time() - t0)
    return first, statistics.median(times), out


def _fmd_window(fm, start: int, n: int, step: int):
    """FMD text codes at start + i*step, i < n (step = +1 or -1)."""
    if step > 0:
        return fm.fetch_fmd(start, start + n)
    return fm.fetch_fmd(start - n + 1, start + 1)[::-1]


def _mutate(rng, seq, sub_rate=0.02, indel=True):
    import numpy as np
    q = np.array(seq, dtype=np.uint8)
    hit = rng.random(len(q)) < sub_rate
    q[hit] = (q[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    if indel and len(q) > 30 and rng.random() < 0.3:
        cut = int(rng.integers(10, len(q) - 10))
        n = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            q = np.concatenate([q[:cut], q[cut + n:]])
        else:
            q = np.concatenate([q[:cut], rng.integers(0, 4, n).astype(
                np.uint8), q[cut:]])
    return q


def _desc_tasks(fm, rng, B, qmax, tlens, qlens, mutate=True):
    """Tasks whose query derives from a genome window and whose target is
    that window, fetched from the FMD text in either direction. Returns
    (reads (B, qmax) uint8, queries, targets, tstart, tdir)."""
    import numpy as np
    L = fm.l_pac
    reads = np.full((B, qmax), 4, np.uint8)
    qs, ts = [], []
    tstart = np.zeros(B, np.int64)
    tdir = np.where(rng.random(B) < 0.5, 1, -1)
    margin = 4000
    for i in range(B):
        base = L if rng.random() < 0.5 else 0      # reverse or forward half
        lo, hi = base + margin, base + L - margin
        tstart[i] = int(rng.integers(lo, hi))
        t = _fmd_window(fm, int(tstart[i]), int(tlens[i]), int(tdir[i]))
        if mutate and rng.random() < 0.9:
            q = _mutate(rng, t[:qlens[i]])[:qmax]
        else:                                      # no homology at all
            q = rng.integers(0, 4, int(qlens[i])).astype(np.uint8)
        reads[i, :len(q)] = q
        qs.append(q)
        ts.append(np.asarray(t, np.uint8))
    return reads, qs, ts, tstart, tdir


def phase_kernels(genome: str, seed: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lariat_tpu.align import ksw
    from lariat_tpu.align.batch_engine import BatchAlignmentEngine
    from lariat_tpu.index import fmindex, native_ops
    from lariat_tpu.ops import resident, sw_global_batch

    fm = fmindex.FMIndex.load_dir(genome)
    eng = BatchAlignmentEngine(fm)
    opt = eng.opt
    mat = np.asarray(ksw.fill_score_matrix(opt.match_score,
                                           opt.mismatch_penalty))
    mat_d = jnp.asarray(mat)
    tp = eng._tier_plan(151)
    rng = np.random.default_rng(seed)
    pac_words, l_pac = eng._pac_resident()
    gaps = (opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
            opt.gap_extend_ins)
    print(f"genome: {fm.l_pac:,} bp, {len(fm.contigs)} contigs")

    def report(name, shape, first, med, n_ok, n):
        print(f"kernel {name} {shape}: {n_ok}/{n} bit-identical to the "
              f"native reference; first call {first:.2f} s (compile), "
              f"median {med * 1e3:.2f} ms/wave over {REPS} waves")
        if n_ok != n:
            raise SystemExit(f"kernel {name}: {n - n_ok} of {n} differ")

    # --- extend wave at the 151 bp ext tiers (largest tier shape) ---------
    Lq, Lt = tp["ext"]["q_tiers"][-1], tp["ext"]["t_tiers"][-1]
    qlens = rng.integers(1, 152, EXT_B)
    tlens = np.minimum(qlens + rng.integers(0, 300, EXT_B), Lt)
    reads, qs, ts, tstart, tdir = _desc_tasks(fm, rng, EXT_B, Lq, tlens,
                                              qlens)
    qlen = np.array([len(q) for q in qs])
    h0 = rng.integers(opt.min_seed_len, 152, EXT_B)
    w = np.where(rng.random(EXT_B) < 0.9, opt.band_width,
                 opt.band_width << 1)
    desc = resident.pack_desc(np.arange(EXT_B), np.zeros(EXT_B),
                              np.ones(EXT_B), qlen, tstart, tdir, tlens, h0,
                              w, l_pac)
    reads_d = jax.device_put(reads)
    key = gaps + (opt.pen_clip5, opt.zdrop)
    first, med, rows = _timed(lambda: np.asarray(
        resident.extend_wave_resident(reads_d, pac_words, l_pac, desc,
                                      mat_d, Lq=Lq, Lt=Lt, opt_key=key)))
    n_ok = 0
    for i in range(EXT_B):
        r = ksw.extend(qs[i], ts[i], mat, *gaps, int(w[i]), opt.pen_clip5,
                       opt.zdrop, int(h0[i]))
        n_ok += (r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off) == \
            tuple(int(v) for v in rows[:, i])
    report("extend", (EXT_B, Lq, Lt), first, med, n_ok, EXT_B)

    # --- reg2aln wave: banded global DP + device walk, one download -------
    Lq, Lt = tp["r2a"]["q_tiers"][-1], tp["r2a"]["t_tiers"][0]
    qlens = rng.integers(60, 152, R2A_B)
    tlens = np.minimum(qlens + rng.integers(-4, 5, R2A_B), Lt)
    reads, qs, ts, tstart, tdir = _desc_tasks(fm, rng, R2A_B, Lq, tlens,
                                              qlens)
    qlen = np.array([len(q) for q in qs], np.int32)
    tlen = np.asarray(tlens, np.int32)
    wv = np.maximum(rng.choice([5, 13, 40, 100], R2A_B),
                    np.abs(qlen - tlen)).astype(np.int32)
    desc = resident.pack_desc(np.arange(R2A_B), np.zeros(R2A_B),
                              np.ones(R2A_B), qlen, tstart, tdir, tlen,
                              np.zeros(R2A_B), wv, l_pac)
    reads_d = jax.device_put(reads)

    def r2a_wave():
        q, t = resident.build_qt(reads_d, pac_words, l_pac, desc, Lq=Lq,
                                 Lt=Lt)
        res, S = eng._global_wave(q, qlen, t, tlen, wv)
        blob = np.asarray(sw_global_batch.traceback_ops_fused(
            res.z, qlen, tlen, wv, res.score, S=S))
        packed, score, i_fin, k_fin = sw_global_batch.split_traceback_blob(
            blob, S)
        return score, sw_global_batch.cigars_from_ops_packed(
            packed, i_fin, k_fin, S)

    first, med, (score, (cig, nops)) = _timed(r2a_wave)
    n_ok = 0
    for i in range(R2A_B):
        ws, wc = ksw.global_align(qs[i], ts[i], mat, *gaps, int(wv[i]))
        n = int(nops[i])
        got = list(zip(cig[i, 0:2 * n:2].tolist(), cig[i, 1:2 * n:2].tolist()))
        n_ok += int(score[i]) == ws and got == wc
    report("reg2aln+walk", (R2A_B, Lq, Lt), first, med, n_ok, R2A_B)

    # --- mate-rescue local two-pass at the rescue-window tiers ------------
    q_t, t_t = tp["loc"]["q_tiers"], tp["loc"]["t_tiers"]
    tasks = []
    for _ in range(LOC_B):
        pos = int(rng.integers(4000, fm.l_pac - 4000))
        win = fm.fetch_fmd(pos, pos + t_t[0])
        if rng.random() < 0.7:
            off = int(rng.integers(0, t_t[0] - 151))
            q = _mutate(rng, win[off:off + 151], sub_rate=0.05)
        else:
            q = rng.integers(0, 4, 151).astype(np.uint8)
        tasks.append((np.asarray(q, np.uint8), np.asarray(win, np.uint8)))
    minsc = opt.min_seed_len * opt.match_score
    first, med, got = _timed(lambda: ksw.local_align_batch(
        tasks, mat, *gaps, minsc, q_tiers=q_t, t_tiers=t_t))
    want = ksw.local_align_batch_native(tasks, mat, *gaps, minsc)
    n_ok = sum(g == r for g, r in zip(got, want))
    report("local2pass", ksw.local_wave_shape(tasks, q_t, t_t), first, med,
           n_ok, LOC_B)

    # --- device SMEM seeding against the genome's index --------------------
    seed_reads = []
    for _ in range(SEED_READS):
        pos = int(rng.integers(4000, 2 * fm.l_pac - 4000))
        seed_reads.append(_mutate(rng, fm.fetch_fmd(pos, pos + 151),
                                  sub_rate=0.01))
    t0 = time.time()
    dfm, dg, smem_device = eng._dseed_state(wait=True)
    print(f"index upload to the device: {time.time() - t0:.2f} s")
    first, med, (g_mems, g_rbegs) = _timed(
        lambda: smem_device.collect_seeds_rbegs_device(dfm, dg, fm,
                                                       seed_reads, opt))
    w_mems, w_rbegs = native_ops.collect_seeds_rbegs_batch(fm, seed_reads,
                                                           opt)
    n_ok = sum(np.array_equal(np.asarray(gm).reshape(-1, 5),
                              np.asarray(wm).reshape(-1, 5))
               and np.array_equal(np.asarray(gr), np.asarray(wr))
               for gm, wm, gr, wr in zip(g_mems, w_mems, g_rbegs, w_rbegs))
    report("smem-seed", (SEED_READS, 151), first, med, n_ok, SEED_READS)


# ------------------------------------------------------------- CLI phase

_WAVES = re.compile(r"device waves: (\d+) \(seed (\d+) ext (\d+) loc (\d+) "
                    r"r2a (\d+)\)\s+wave shapes (\d+)\s+wave wall ([0-9.]+)s"
                    r"\s+busy fraction ([0-9.]+)\s+primed pairs (\d+)\s+"
                    r"host pairs (\d+)")
_RATE = re.compile(r"Processed (\d+) read pairs across (\d+) barcodes in "
                   r"([0-9.]+)s \(([0-9.]+) pairs/s\)")


def run_cli(mode: str, fa: str, fq: str, out: str, log_dir,
            timeout: float) -> dict:
    env = _env()
    if mode == "on":
        env["LARIAT_DEVICE_SEED"] = "1"
    log = os.path.join(log_dir, f"cli_{mode}.log") if log_dir else None
    t0 = time.time()
    stdout = _child([sys.executable, "-m", "lariat_tpu.cli", "-reads", fq,
                     "-genome", fa, "-output", out,
                     "-threads", str(CLI_THREADS),
                     "-use_device", mode], f"CLI -use_device {mode}",
                    timeout, env=env, log=log)
    wall = time.time() - t0
    m = _RATE.search(stdout)
    if not m:
        raise SystemExit(f"CLI -use_device {mode}: no throughput line")
    info = {"pairs": int(m.group(1)), "barcodes": int(m.group(2)),
            "run_s": float(m.group(3)), "pairs_s": float(m.group(4)),
            "wall_s": wall}
    for line in stdout.splitlines():
        if line.startswith(("device priming on", "device waves:")):
            print(f"  [{mode}] {line}")
    if mode == "on":
        dev = re.search(r"device priming on (.*)", stdout)
        w = _WAVES.search(stdout)
        if not dev or "(gpu," not in dev.group(1) or not w:
            raise SystemExit("CLI -use_device on did not prime on the GPU")
        keys = ("waves", "seed", "ext", "loc", "r2a", "shapes")
        info.update({k: int(w.group(i + 1)) for i, k in enumerate(keys)})
        info.update(busy=float(w.group(8)), primed=int(w.group(9)),
                    host=int(w.group(10)))
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--data", default=os.path.join(REPO, ".smoke_data"),
                    help="directory for the genome, index and reads "
                         "(made once per seed and reused)")
    ap.add_argument("--log-dir", default="",
                    help="keep the CLI runs' full output here")
    ap.add_argument("--phase", choices=["env", "kernels"], default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--genome", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase == "env":
        phase_env()
        return 0
    if args.phase == "kernels":
        phase_kernels(args.genome, args.seed)
        return 0

    t_start = time.time()
    for rel in ("lariat_tpu/cli.py", "native/Makefile",
                "tools/synth_genome.py", "tools/sim_reads.py"):
        if not os.path.exists(os.path.join(REPO, rel)):
            print(f"chip_smoke: {rel} is missing; run this script from a "
                  f"checkout of the repository", file=sys.stderr)
            return 2
    me = [sys.executable, os.path.abspath(__file__)]

    # 1. environment
    out = _child(me + ["--phase", "env"], "environment check", 300)
    device = json.loads(out.split("DEVICE ", 1)[1].splitlines()[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True,
                   stdout=subprocess.DEVNULL)
    sys.path.insert(0, REPO)
    from lariat_tpu.index.suffix import _load_native
    if _load_native() is None:
        raise SystemExit("native library failed to load")

    # 2. inputs
    print(f"genome cut: chr20-sized synthetic genome (synth_genome --scale "
          f"{GENOME_SCALE}); hg38 (3.1 Gbp) waits for a faster index build")
    fa, fq, t_inputs = make_inputs(args.data, args.seed)
    print(f"inputs ready in {t_inputs:.1f} s (set-up): {fa}, {fq}")

    # 3. kernel parity on the card
    _child(me + ["--phase", "kernels", "--genome", fa, "--seed",
                 str(args.seed)], "kernel parity", 600)

    # 4. end to end through the CLI, one child at a time
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    outs = {m: os.path.join(args.data, f"out_{m}") for m in ("on", "off")}
    runs = {m: run_cli(m, fa, fq, outs[m], args.log_dir, 600)
            for m in ("on", "off")}
    on = runs["on"]
    total = N_BARCODES * PAIRS_PER_BC
    if on["pairs"] != total or on["primed"] != total or on["host"] != 0:
        raise SystemExit(f"-use_device on: {on['pairs']} pairs, primed "
                         f"{on['primed']}, host {on['host']} (want {total} "
                         f"primed, 0 host)")
    for k in ("seed", "ext", "loc", "r2a"):
        if on[k] <= 0:
            raise SystemExit(f"-use_device on ran no {k} waves")
    print(f"primed pairs {on['primed']}  host pairs {on['host']}  waves: "
          f"seed {on['seed']} ext {on['ext']} loc {on['loc']} r2a "
          f"{on['r2a']}; {on['shapes']} distinct DP wave shapes")
    n = compare_bams(outs["off"], outs["on"])
    print(f"BAM parity: {n} records identical between -use_device on and "
          f"off")
    for m in ("on", "off"):
        r = runs[m]
        print(f"smoke timing, not a benchmark: -use_device {m}: "
              f"{r['pairs_s']:.1f} pairs/s over {r['run_s']:.1f} s, "
              f"{r['wall_s']:.1f} s with start-up")
    print(f"smoke wall time {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
