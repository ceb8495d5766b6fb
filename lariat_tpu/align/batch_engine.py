"""Batch alignment engine: the real aligner path with device-batched DP.

Exact-parity batching of mem_chain2aln's seed extension and mem_reg2aln's
global realignment:

The reference extends seeds *sequentially* (each seed's skip test consults
regions produced by earlier extensions — SURVEY.md section 7 "hard parts").
Extension RESULTS, however, do not depend on those decisions — only on the
(seed, window) inputs. So we extend speculatively in batched waves and then
REPLAY the sequential control flow on the host using cached results:

  wave L1: left extensions of every kept seed (band w)
  wave L2: band-doubled retries (the rare max_off overflow cases)
  wave R1/R2: right extensions (h0 chains from the left result, which is
              known after L; no dependence on skip decisions)
  replay:  chain2aln's exact seed loop, consuming cached results
  wave M:  mate-rescue local SW over the insert windows (local_align_device)
  wave G:  reg2aln banded global alignments (+ band retries), the traceback
           walked on the device

Results are bit-identical to AlignmentEngine (asserted by tests); only the
schedule changes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import AlignerConfig, PairModel
from ..index.fmindex import FMIndex
from . import ksw
from .chaining import Chain, chain_seeds, filter_chains
from .engine import (AlignmentEngine, OP_D, OP_M, OP_S,
                     SingleReadAlignment)
from .extension import MAX_BAND_TRY, AlnReg, cal_max_gap

MAX_EXT_LEN = 1 << 30

import os as _os

# LARIAT_WAVE_TRACE=1 prints one line per device wave with the time split
# (host build / dispatch / download) and transfer sizes.
WAVE_TRACE = _os.environ.get("LARIAT_WAVE_TRACE") == "1"


def _wtrace(kind: str, shape, t_build: float, t_disp: float, t_dl: float,
            up_b: int, dn_b: int) -> None:
    print(f"[wtrace] {kind:5s} {str(shape):18s} build {t_build*1e3:6.0f}ms "
          f"disp {t_disp*1e3:6.0f}ms dl {t_dl*1e3:6.0f}ms "
          f"up {up_b/1e6:7.2f}MB dn {dn_b/1e6:6.2f}MB", flush=True)


def _pow2_bucket(n: int, floor: int = 128) -> int:
    """Round batch sizes up to powers of two: distinct shapes retrace the
    whole jitted wave, so sizes must come from a tiny fixed set."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class _ExtTask:
    key: tuple
    query: np.ndarray
    target: np.ndarray
    h0: int
    w: int


class _ExtBatcher:
    """Collect extension tasks, run them in one device batch."""

    def __init__(self):
        self.tasks: List[_ExtTask] = []
        self.results: Dict[tuple, ksw.ExtendResult] = {}

    def add(self, key, query, target, h0, w):
        self.tasks.append(_ExtTask(key, query, target, int(h0), int(w)))

    def run(self, opt: AlignerConfig) -> None:
        if not self.tasks:
            return
        from ..ops import sw_batch
        B = len(self.tasks)
        Lq = max((len(t.query) for t in self.tasks), default=1) or 1
        Lt = max((len(t.target) for t in self.tasks), default=1) or 1
        # pad to coarse buckets to limit recompilation
        Lq = -(-Lq // 64) * 64
        Lt = -(-Lt // 64) * 64
        Bp = _pow2_bucket(B)
        qa = np.zeros((Bp, Lq), np.int32)
        ta = np.zeros((Bp, Lt), np.int32)
        qlen = np.zeros(Bp, np.int32)
        tlen = np.zeros(Bp, np.int32)
        h0 = np.zeros(Bp, np.int32)
        w = np.zeros(Bp, np.int32)
        for i, t in enumerate(self.tasks):
            qa[i, :len(t.query)] = t.query
            ta[i, :len(t.target)] = t.target
            qlen[i] = len(t.query)
            tlen[i] = len(t.target)
            h0[i] = t.h0
            w[i] = t.w
        mat = np.asarray(ksw.fill_score_matrix(opt.match_score,
                                               opt.mismatch_penalty))
        res = sw_batch.extend_batch(
            qa, qlen, ta, tlen, mat, w, h0,
            o_del=opt.gap_open_del, e_del=opt.gap_extend_del,
            o_ins=opt.gap_open_ins, e_ins=opt.gap_extend_ins,
            end_bonus=opt.pen_clip5, zdrop=opt.zdrop, packed=True)
        rows = np.asarray(res)   # ONE transfer: (6+, Bp)
        score, qle, tle, gtle, gscore, moff = (rows[k] for k in range(6))
        for i, t in enumerate(self.tasks):
            self.results[t.key] = ksw.ExtendResult(
                int(score[i]), int(qle[i]), int(tle[i]), int(gtle[i]),
                int(gscore[i]), int(moff[i]))
        self.tasks = []


@dataclasses.dataclass
class _ChainCtx:
    chain: Chain
    rmax0: int
    rmax1: int
    rseq: np.ndarray
    srt: List[int]


class BatchAlignmentEngine(AlignmentEngine):
    """Drop-in engine whose DP inner loops run as device batches."""

    def __init__(self, fm: FMIndex, opt: Optional[AlignerConfig] = None,
                 pair: Optional[PairModel] = None, mesh=None):
        """``mesh``: optional 1-D jax.sharding.Mesh with axis "data"; wave
        batches shard over it (batch dim) with the small per-wave params
        replicated, so the production DP waves run SPMD across chips while
        the host replay stays identical (bit-equality asserted by
        __graft_entry__.dryrun_multichip)."""
        super().__init__(fm, opt, pair)
        self.mesh = mesh
        self.shard_waves = 0          # waves whose inputs were mesh-sharded
        self.shard_log: list = []     # per sharded wave: {"Bp", "real"}
        # device wave accounting (wall time spent with a wave dispatched or
        # downloading, summed across priming threads): the CLI reports
        # wall / elapsed as the device-busy fraction proxy, the per-kind
        # counts, and how many distinct DP wave shapes were compiled
        self.wave_stats = {"wall": 0.0, "n": 0, "seed": 0, "ext": 0,
                           "loc": 0, "r2a": 0}
        self.wave_shapes: set = set()
        self._stats_lock = threading.Lock()   # priming threads share them

    def _count_wave(self, kind: str, t_dev: float, shapes=(),
                    n: int = 1) -> None:
        with self._stats_lock:
            self.wave_stats["wall"] += time.time() - t_dev
            self.wave_stats["n"] += n
            self.wave_stats[kind] += n
            for shape in shapes:
                self.wave_shapes.add((kind,) + tuple(int(v) for v in shape))

    def _pac_resident(self):
        """(pac_words_devicearray, l_pac) cached on the engine — the 2-bit
        genome uploaded once, shared by every resident-fed wave."""
        pr = getattr(self, "_pac_res", None)
        if pr is None:
            import jax
            import jax.numpy as jnp
            ds = getattr(self, "_dseed", None)
            if ds is not None:
                pr = (ds[1].pac_words, int(self.fm.l_pac))
            else:
                from ..ops.fm_batch import pac_words_host
                pr = (jax.device_put(jnp.asarray(pac_words_host(self.fm))),
                      int(self.fm.l_pac))
            self._pac_res = pr
        return pr

    def _shard_wave(self, *arrays, real=None):
        """device_put wave batches over the data mesh (batch dim sharded);
        returns (arrays, inv). Without a mesh: (arrays, None).

        Real tasks fill the first rows of a padded wave, so contiguous
        sharding would hand whole devices nothing but padding (measured
        12x real-task imbalance on the dryrun). Rows are therefore
        round-robined across device blocks before the device_put — every
        device gets an even share of REAL work — and consumers restore
        task order by indexing downloaded per-row results with ``inv``.
        Wave batch sizes are pow2 >= 128 so they divide any power-of-two
        device count."""
        if self.mesh is None:
            return arrays, None
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        n = self.mesh.devices.size
        Bp = int(np.shape(arrays[0])[0])
        rpb = Bp // n
        new = np.arange(Bp)
        perm = (new % rpb) * n + new // rpb      # perm[new_row] = old_task
        inv = (new % n) * rpb + new // n         # inv[old_task] = new_row
        rec = {"Bp": Bp, "n_dev": n}
        if real is not None:
            rec["real"] = int(real)
        else:
            for a in arrays:
                if np.ndim(a) == 1 and getattr(np.asarray(a).dtype, "kind",
                                               "") == "i":
                    rec["real"] = int(np.count_nonzero(np.asarray(a)))
                    break
        out = []
        for a in arrays:
            spec = P("data", *([None] * (np.ndim(a) - 1)))
            out.append(jax.device_put(np.asarray(a)[perm],
                                      NamedSharding(self.mesh, spec)))
        self.shard_waves += 1
        self.shard_log.append(rec)
        return tuple(out), inv

    def _tier_plan(self, qmax: int) -> dict:
        """Wave-tier shape sets derived from the longest query seen so far.

        Every distinct (B, Lq, Lt) wave shape is one more XLA compile, so
        dims are pinned to a small tier set derived from the observed read
        length (250 bp reads get fitting tiers instead of retracing per
        batch). On an H100 the smoke's cold CLI run compiled 12 DP wave
        shapes in 75 s with the plan against 17 in 87 s with plain
        64-column buckets (PERF.md). The plan is sticky: it only regrows
        when a longer read shows up (one recompile, not one per batch).
        """
        tp = getattr(self, "_tiers", None)
        if tp is not None and qmax <= tp["qmax"]:
            return tp

        def c64(v: int) -> int:
            return -(-max(v, 64) // 64) * 64

        qT = c64(qmax)
        # mate-rescue window length: high - low + read length
        # (engine._rescue_window geometry)
        rT = c64(self.pair.high - self.pair.low + qmax)
        tp = {
            "qmax": qT,
            # seed extension: query stubs (<=64) and full flanks; targets
            # add band slack either side
            "ext": dict(q_tiers=(64, qT), t_tiers=(qT, 3 * qT)),
            # reg2aln global: target = query +- inferred band (ladder
            # retries widen into the higher tiers); the wave B is pinned to
            # the chunk size, since ladder retry waves are tiny and varied
            "r2a": dict(q_tiers=(64, qT), t_tiers=(qT, 2 * qT, 3 * qT),
                        pad_b=lambda n: max(self.R2ALN_CHUNK,
                                            _pow2_bucket(n))),
            # local rescue SW: query = the (reversed) mate read, target =
            # the insert window; second tier covers band-doubled retries
            "loc": dict(q_tiers=(qT, 4 * qT), t_tiers=(rT, 2 * rT)),
        }
        self._tiers = tp
        return tp

    # ------------------------------------------------------------- batching

    def _prepare_chains(self, q: np.ndarray,
                        mems=None, rbegs=None) -> List[_ChainCtx]:
        opt, fm = self.opt, self.fm
        chains = filter_chains(opt, chain_seeds(fm, q, opt, mems, rbegs))
        out = []
        l_query = len(q)
        for c in chains:
            if not c.seeds:
                continue
            rmax0, rmax1 = fm.seq_len, 0
            for t in c.seeds:
                b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                     + cal_max_gap(opt, l_query - t.qbeg - t.len))
                rmax0 = min(rmax0, b)
                rmax1 = max(rmax1, e)
            rmax0 = max(rmax0, 0)
            rmax1 = min(rmax1, fm.seq_len)
            if rmax0 < fm.l_pac < rmax1:
                if c.seeds[0].rbeg < fm.l_pac:
                    rmax1 = fm.l_pac
                else:
                    rmax0 = fm.l_pac
            rseq = fm.fetch_fmd(rmax0, rmax1)
            srt = sorted(range(len(c.seeds)),
                         key=lambda i: (c.seeds[i].score, i), reverse=True)
            out.append(_ChainCtx(c, rmax0, rmax1, rseq, srt))
        return out

    def align_batch(self, seqs: List[bytes]) -> List[List[AlnReg]]:
        """Candidate regions for a batch of reads (mem_align1_core xN).

        Bit-identical to calling ``align1`` per read. Preferred path: the
        C++ two-phase session (native/align1.cpp a1s_*) drives chain/filter/
        replay while the extensions run as device waves — no per-seed Python.
        Falls back to the original Python replay when the native library is
        unavailable (LARIAT_NO_NATIVE_ALIGN1 keeps it testable).
        """
        from . import native_engine
        if native_engine.Align1Session.available():
            out = self._align_batch_session(seqs)
            if out is not None:
                return out
        return self._align_batch_python(seqs)

    # genome scale above which device seeding is on by default: host C++
    # seeding is FM-cache-miss-bound at gigabase scale while the device
    # two-pointer machine is ~flat in genome size; small genomes keep the
    # (very fast there) host seeder
    DEVICE_SEED_AUTO_MIN_LPAC = 1_000_000_000

    def _device_seed(self, nonempty):
        """Device 3-round SMEM seeding + SA walks; bit-identical to the
        native C++ (ops/smem_device.py). Uploads the FM arrays to device
        memory on first use (~7 GB at hg38 scale). None -> use the host C++
        seeder.

        Policy: LARIAT_DEVICE_SEED=1 forces it on, and then a failure
        raises; =0 forces it off; unset -> AUTO: on when JAX's backend is
        an accelerator and the genome is gigabase-scale (where the host
        seeder is the bottleneck). Under AUTO the upload runs on a
        background thread while the host seeder serves batches, and a
        failure falls back to the host seeder for the rest of the run."""
        import os
        flag = os.environ.get("LARIAT_DEVICE_SEED")
        if flag == "0" or not nonempty or getattr(self, "_dseed_off", False):
            return None
        forced = flag == "1"
        if not forced:
            import jax
            if (jax.default_backend() == "cpu"
                    or self.fm.l_pac < self.DEVICE_SEED_AUTO_MIN_LPAC):
                return None
        try:
            st = self._dseed_state(wait=forced)
            if st is None:
                return None          # still uploading: host seeder
            dfm, dg, smem_device = st
            t_dev = time.time()
            out = smem_device.collect_seeds_rbegs_device(
                dfm, dg, self.fm, nonempty, self.opt)
            self._count_wave("seed", t_dev)
            return out
        except Exception as e:
            if forced:
                raise
            import sys
            print(f"device seeding unavailable ({e}); host C++ seeding",
                  file=sys.stderr)
            self._dseed_off = True
            return None

    def _dseed_state(self, wait: bool):
        """(DeviceFMIndex, DeviceGenome, smem_device) once the index upload
        has landed; starts the upload thread on first call. ``wait`` blocks
        for it; otherwise None while it is in flight."""
        st = getattr(self, "_dseed", None)
        if st is not None:
            return st
        th = getattr(self, "_dseed_thread", None)
        if th is None:
            def _build():
                try:
                    import jax

                    from ..ops import fm_batch, smem_device
                    from ..parallel.align_step import DeviceGenome
                    dfm = fm_batch.DeviceFMIndex.from_host(self.fm)
                    dg = DeviceGenome.from_host(self.fm)
                    # force the transfers now, off the hot path
                    jax.block_until_ready(dfm.fused)
                    np.asarray(dfm.L2)
                    self._dseed = (dfm, dg, smem_device)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    self._dseed_err = e
            th = threading.Thread(target=_build, daemon=True,
                                  name="lariat-dseed-upload")
            self._dseed_thread = th
            th.start()
        if wait:
            th.join()
        err = getattr(self, "_dseed_err", None)
        if err is not None:
            raise err
        return getattr(self, "_dseed", None)

    def _align_batch_session(self, seqs: List[bytes]
                             ) -> Optional[List[List[AlnReg]]]:
        from .engine import encode_read
        from . import native_engine
        from ..index import native_ops
        from ..ops import sw_batch
        opt = self.opt
        qs = [encode_read(s) for s in seqs]
        nonempty = [q for q in qs if len(q)]
        seeded = self._device_seed(nonempty)
        if seeded is None:
            seeded = native_ops.collect_seeds_rbegs_batch(self.fm, nonempty,
                                                          opt)
        if seeded is None:
            return None
        mems_ne, rbegs_ne = seeded
        empty_m = np.zeros((0, 5), np.int64)
        empty_b = np.zeros(0, np.int64)
        mems_list, rbegs_list = [], []
        it = iter(zip(mems_ne, rbegs_ne))
        for q in qs:
            if len(q):
                m, b = next(it)
                mems_list.append(m)
                rbegs_list.append(b)
            else:
                mems_list.append(empty_m)
                rbegs_list.append(empty_b)
        sess = native_engine.Align1Session(self.fm, opt, qs, mems_list,
                                           rbegs_list)
        import os
        import time
        dbg = os.environ.get("LARIAT_WAVE_DEBUG") == "1"
        # resident feed (default): upload the batch's reads once + ~48 B
        # task descriptors per wave; q/t tiles are gathered on device from
        # reads + the engine-cached 2-bit pac (ops/resident.py). The
        # materialized-buffer path remains as LARIAT_NO_RESIDENT=1.
        use_res = (os.environ.get("LARIAT_NO_RESIDENT") != "1"
                   and hasattr(sess.lib, "a1s_fill_desc"))
        if use_res:
            from ..ops import resident
            reads_res = resident.put_reads(qs)
            pac_words, l_pac = self._pac_resident()
            import jax.numpy as jnp
            mat_d = jnp.asarray(ksw.fill_score_matrix(
                opt.match_score, opt.mismatch_penalty))
        try:
            mat = np.asarray(ksw.fill_score_matrix(opt.match_score,
                                                   opt.mismatch_penalty))
            tiers = self._tier_plan(
                max((len(s) for s in seqs), default=64))["ext"]
            while sess.pending():
                t_wave = time.time()
                bonus = opt.pen_clip5 if sess.phase() == 0 else opt.pen_clip3
                if use_res:
                    (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
                     Lq, Lt) = sess.wave_descs(**tiers)
                    from ..ops.resident import (extend_wave_resident,
                                                pack_desc)
                    desc = pack_desc(rid, qstart, qdir, qlen, tstart,
                                     tdir, tlen, h0, w, l_pac)
                    nreal = int(np.count_nonzero(qlen))
                    (desc,), inv = self._shard_wave(desc, real=nreal)
                    t_dev = time.time()
                    res = extend_wave_resident(
                        reads_res.codes, pac_words, l_pac, desc, mat_d,
                        Lq=Lq, Lt=Lt,
                        opt_key=(opt.gap_open_del, opt.gap_extend_del,
                                 opt.gap_open_ins, opt.gap_extend_ins,
                                 bonus, opt.zdrop))
                    up_b = desc.size * desc.dtype.itemsize \
                        if hasattr(desc, "dtype") else 0
                    shape = (len(qlen), Lq, Lt)
                else:
                    q, qlen, t, tlen, h0, w = sess.wave_arrays(**tiers)
                    (q, qlen, t, tlen, h0, w), inv = self._shard_wave(
                        q, qlen, t, tlen, h0, w)
                    t_dev = time.time()
                    res = sw_batch.extend_batch(
                        q, qlen, t, tlen, mat, w, h0, packed=True,
                        o_del=opt.gap_open_del, e_del=opt.gap_extend_del,
                        o_ins=opt.gap_open_ins, e_ins=opt.gap_extend_ins,
                        end_bonus=bonus, zdrop=opt.zdrop)
                    up_b = sum(np.asarray(a).nbytes
                               for a in (q, t, qlen, tlen, h0, w))
                    shape = (len(qlen), q.shape[1], t.shape[1])
                t_disp = time.time()
                rows = np.asarray(res)   # ONE transfer per wave: (6, B)
                if inv is not None:
                    rows = rows[:, inv]  # undo the shard round-robin
                if WAVE_TRACE:
                    _wtrace("ext", shape, t_dev - t_wave, t_disp - t_dev,
                            time.time() - t_disp, up_b, rows.nbytes)
                self._count_wave("ext", t_dev, [shape])
                sess.feed(rows[0], rows[1], rows[2], rows[3], rows[4],
                          rows[5])
                if dbg:
                    print(f"[wave] phase={sess.phase()} B={shape[0]} "
                          f"q={shape[1]} t={shape[2]} "
                          f"{time.time() - t_wave:.2f}s", flush=True)
            return sess.finish()
        finally:
            sess.close()

    def _align_batch_python(self, seqs: List[bytes]) -> List[List[AlnReg]]:
        """Original Python wave replay (executable reference for the session
        path; LARIAT_NO_NATIVE_ALIGN1=1 forces it)."""
        from .engine import encode_read
        from ..index import native_ops
        from .chaining import enumerate_occurrences
        from .seeding import Intv
        opt = self.opt
        qs = [encode_read(s) for s in seqs]
        # native batched seeding + one batched SA dereference for all reads
        nonempty = [q for q in qs if len(q)]
        seeds_per = native_ops.collect_seeds_batch(self.fm, nonempty, opt)
        mems_per: List[Optional[List[Intv]]] = [None] * len(qs)
        rbegs_per: List[Optional[List[int]]] = [None] * len(qs)
        if seeds_per is not None:
            it = iter(seeds_per)
            all_rows = []
            occ_info = []
            for i, q in enumerate(qs):
                if not len(q):
                    continue
                arr = next(it)
                mems = [Intv(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                             int(r[4])) for r in arr]
                mems_per[i] = mems
                occs = enumerate_occurrences(mems, opt)
                occ_info.append((i, len(occs)))
                all_rows.extend(row for _, row in occs)
            rows = np.asarray(all_rows, dtype=np.int64)
            rb = self.fm.sa_lookup_many(rows) if len(rows) else                 np.zeros(0, np.int64)
            off = 0
            for i, n in occ_info:
                rbegs_per[i] = [int(v) for v in rb[off:off + n]]
                off += n
        ctxs: List[List[_ChainCtx]] = [
            self._prepare_chains(q, mems_per[i], rbegs_per[i])
            if len(q) else [] for i, q in enumerate(qs)]
        # ---- wave L: left extensions (band try ladder, speculative) -------
        batcher = _ExtBatcher()
        for ri, clist in enumerate(ctxs):
            for ci, ctx in enumerate(clist):
                for si in ctx.srt:
                    s = ctx.chain.seeds[si]
                    if s.qbeg:
                        qseg = qs[ri][:s.qbeg][::-1].astype(np.int32)
                        tseg = ctx.rseq[:s.rbeg - ctx.rmax0][::-1].astype(
                            np.int32)
                        batcher.add((ri, ci, si, "L", 0), qseg, tseg,
                                    s.len * opt.match_score,
                                    opt.band_width)
        batcher.run(opt)
        # band-doubling retries for left
        retry = []
        for t_key, res in list(batcher.results.items()):
            if t_key[3] != "L" or t_key[4] != 0:
                continue
            if not (res.max_off < (opt.band_width >> 1) + (opt.band_width >> 2)):
                retry.append(t_key)
        for key in retry:
            ri, ci, si, _, _ = key
            ctx = ctxs[ri][ci]
            s = ctx.chain.seeds[si]
            qseg = qs[ri][:s.qbeg][::-1].astype(np.int32)
            tseg = ctx.rseq[:s.rbeg - ctx.rmax0][::-1].astype(np.int32)
            batcher.add((ri, ci, si, "L", 1), qseg, tseg,
                        s.len * opt.match_score, opt.band_width << 1)
        batcher.run(opt)

        def left_result(ri, ci, si) -> Tuple[ksw.ExtendResult, int]:
            """Replay the MAX_BAND_TRY ladder for one left extension."""
            prev = -1
            for i in range(MAX_BAND_TRY):
                aw = opt.band_width << i
                res = batcher.results.get((ri, ci, si, "L", i))
                if res is None:  # retry not run => ladder stopped earlier
                    break
                if res.score == prev or res.max_off < (aw >> 1) + (aw >> 2):
                    return res, aw
                prev = res.score
                last, law = res, aw
            return (res, aw) if res is not None else (last, law)

        # ---- wave R: right extensions (h0 from the left outcome) ----------
        right_specs: Dict[tuple, Tuple[int, int]] = {}
        for ri, clist in enumerate(ctxs):
            for ci, ctx in enumerate(clist):
                for si in ctx.srt:
                    s = ctx.chain.seeds[si]
                    l_query = len(qs[ri])
                    if s.qbeg + s.len == l_query:
                        continue
                    if s.qbeg:
                        # a->score after the left step is the local-extension
                        # max regardless of the gscore (to-end) choice
                        lres, _ = left_result(ri, ci, si)
                        sc0 = lres.score
                    else:
                        sc0 = s.len * opt.match_score
                    qe = s.qbeg + s.len
                    re_off = s.rbeg + s.len - ctx.rmax0
                    qseg = qs[ri][qe:].astype(np.int32)
                    tseg = ctx.rseq[re_off:].astype(np.int32)
                    right_specs[(ri, ci, si)] = (sc0, re_off)
                    batcher.add((ri, ci, si, "R", 0), qseg, tseg, sc0,
                                opt.band_width)
        batcher.run(opt)
        retry = []
        for t_key, res in list(batcher.results.items()):
            if t_key[3] != "R" or t_key[4] != 0:
                continue
            sc0 = right_specs[t_key[:3]][0]
            if (res.score != sc0 and not (
                    res.max_off
                    < (opt.band_width >> 1) + (opt.band_width >> 2))):
                retry.append(t_key)
        for key in retry:
            ri, ci, si, _, _ = key
            ctx = ctxs[ri][ci]
            s = ctx.chain.seeds[si]
            sc0, re_off = right_specs[(ri, ci, si)]
            qseg = qs[ri][s.qbeg + s.len:].astype(np.int32)
            tseg = ctx.rseq[re_off:].astype(np.int32)
            batcher.add((ri, ci, si, "R", 1), qseg, tseg, sc0,
                        opt.band_width << 1)
        batcher.run(opt)

        def right_result(ri, ci, si) -> Tuple[ksw.ExtendResult, int]:
            # C's loop reads prev = a->score, which entering the right step
            # equals sc0 (the left outcome)
            prev = right_specs[(ri, ci, si)][0]
            res = law = None
            for i in range(MAX_BAND_TRY):
                aw = opt.band_width << i
                r = batcher.results.get((ri, ci, si, "R", i))
                if r is None:
                    break
                res, law = r, aw
                if r.score == prev or r.max_off < (aw >> 1) + (aw >> 2):
                    return r, aw
                prev = r.score
            return res, law

        # ---- replay mem_chain2aln's exact sequential control flow ---------
        out: List[List[AlnReg]] = []
        for ri, clist in enumerate(ctxs):
            q = qs[ri]
            l_query = len(q)
            regs: List[AlnReg] = []
            for ci, ctx in enumerate(clist):
                c = ctx.chain
                skipped = set()
                for order, si in enumerate(ctx.srt):
                    s = c.seeds[si]
                    hit = None
                    for p in regs:
                        if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                                or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                            continue
                        if s.len - p.seedlen0 > 0.1 * l_query:
                            continue
                        qd = s.qbeg - p.qb
                        rd = s.rbeg - p.rb
                        ww = min(cal_max_gap(self.opt, min(qd, rd)), p.w)
                        if qd - rd < ww and rd - qd < ww:
                            hit = p
                            break
                        qd = p.qe - (s.qbeg + s.len)
                        rd = p.re - (s.rbeg + s.len)
                        ww = min(cal_max_gap(self.opt, min(qd, rd)), p.w)
                        if qd - rd < ww and rd - qd < ww:
                            hit = p
                            break
                    if hit is not None:
                        conflict = False
                        for so in range(order):
                            j = ctx.srt[so]
                            if j in skipped:
                                continue
                            t = c.seeds[j]
                            if t.len < s.len * 0.95:
                                continue
                            if (s.qbeg <= t.qbeg
                                    and s.qbeg + s.len - t.qbeg >= s.len // 4
                                    and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                                conflict = True
                                break
                            if (t.qbeg <= s.qbeg
                                    and t.qbeg + t.len - s.qbeg >= s.len // 4
                                    and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                                conflict = True
                                break
                        if not conflict:
                            skipped.add(si)
                            continue
                    a = AlnReg(w=self.opt.band_width, rid=c.rid,
                               frac_rep=c.frac_rep)
                    aw0 = aw1 = self.opt.band_width
                    if s.qbeg:
                        res, aw0 = left_result(ri, ci, si)
                        a.score = res.score
                        if (res.gscore <= 0
                                or res.gscore <= a.score - self.opt.pen_clip5):
                            a.qb = s.qbeg - res.qle
                            a.rb = s.rbeg - res.tle
                            a.truesc = a.score
                        else:
                            a.qb = 0
                            a.rb = s.rbeg - res.gtle
                            a.truesc = res.gscore
                    else:
                        a.score = a.truesc = s.len * self.opt.match_score
                        a.qb = 0
                        a.rb = s.rbeg
                    if s.qbeg + s.len != l_query:
                        sc0 = a.score
                        res, aw1 = right_result(ri, ci, si)
                        qe = s.qbeg + s.len
                        re_off = s.rbeg + s.len - ctx.rmax0
                        a.score = res.score
                        if (res.gscore <= 0
                                or res.gscore <= a.score - self.opt.pen_clip3):
                            a.qe = qe + res.qle
                            a.re = ctx.rmax0 + re_off + res.tle
                            a.truesc += a.score - sc0
                        else:
                            a.qe = l_query
                            a.re = ctx.rmax0 + re_off + res.gtle
                            a.truesc += res.gscore - sc0
                    else:
                        a.qe = l_query
                        a.re = s.rbeg + s.len
                    a.seedcov = 0
                    for t in c.seeds:
                        if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                                and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                            a.seedcov += t.len
                    a.w = max(aw0, aw1)
                    a.seedlen0 = s.len
                    regs.append(a)
            from .extension import sort_dedup_patch
            regs = sort_dedup_patch(self.fm, q, self.opt, regs, self.mat)
            out.append(regs)
        return out

    def local_align_device(self, tasks):
        """Device-batched mate-rescue local SW (two waves incl. the reversed
        start-coordinate pass); bit-identical to per-task ksw.local_align."""
        from .ksw import local_align_batch, local_wave_shape
        opt = self.opt
        tiers = self._tier_plan(
            max((len(rev) for rev, _ in tasks), default=64))["loc"]
        t_dev = time.time()
        out = local_align_batch(
            tasks,
            self.mat, opt.gap_open_del, opt.gap_extend_del,
            opt.gap_open_ins, opt.gap_extend_ins,
            opt.min_seed_len * opt.match_score,
            shard_fn=self._shard_wave if self.mesh is not None else None,
            **tiers)
        if WAVE_TRACE:
            up = sum(len(rev) + len(ref) for rev, ref in tasks)
            _wtrace("loc", (len(tasks),), 0.0, time.time() - t_dev, 0.0,
                    up, 0)
        shape = local_wave_shape(tasks, **tiers)
        self._count_wave("loc", t_dev, [shape] if shape else [])
        return out

    def prime_regions(self, recs, score_delta: Optional[int] = None
                      ) -> List[tuple]:
        """Device-batch candidate regions for many read pairs.

        With ``score_delta`` given, mate rescue also runs here (DP batched on
        device via rescue_pairs_batch), the final per-candidate global SW
        (mem_reg2aln) runs as device waves too, and the returned per-pair
        tuples are (regs1, regs2, True, sras1, sras2) — workers then
        interpret + walk without touching any DP. Without it, returns
        (regs1, regs2) and workers rescue + reg2aln on host.
        """
        from .engine import encode_read
        seqs = []
        for rec in recs:
            seqs.append(rec.read1)
            seqs.append(rec.read2)
        all_regs = self.align_batch(seqs)
        per_pair = []
        for i, rec in enumerate(recs):
            per_pair.append((all_regs[2 * i] if len(rec.read1) else [],
                             all_regs[2 * i + 1] if len(rec.read2) else []))
        if score_delta is None:
            return per_pair
        pairs = [(encode_read(rec.read1), encode_read(rec.read2), r1, r2)
                 for rec, (r1, r2) in zip(recs, per_pair)]
        self.rescue_pairs_batch(pairs, score_delta,
                                local_align_fn=self.local_align_device)
        # final SW for every post-rescue candidate in one batched session
        # (same task list get_alignments would build: one per region, in
        # reg order — rfa/candidates.py get_alignments)
        tasks = []
        counts = []
        for rec, (r1, r2) in zip(recs, per_pair):
            for reg in r1:
                tasks.append((rec.read1, reg))
            for reg in r2:
                tasks.append((rec.read2, reg))
            counts.append((len(r1), len(r2)))
        # reg2aln_batch chunks + pipelines its device sessions internally
        sras = self.reg2aln_batch(tasks) if tasks else []
        out = []
        off = 0
        for (r1, r2), (n1, n2) in zip(per_pair, counts):
            out.append((r1, r2, True, sras[off:off + n1],
                        sras[off + n1:off + n1 + n2]))
            off += n1 + n2
        return out

    def prime_pairs(self, recs, score_delta: int) -> None:
        """Device-batch candidate generation for many reads (across
        barcodes); caches per-record (ea1, ea2) results that get_chains
        consumes. Amortizes device-wave latency over many barcodes."""
        from .engine import encode_read
        seqs = []
        for rec in recs:
            seqs.append(rec.read1)
            seqs.append(rec.read2)
        all_regs = self.align_batch(seqs)
        pairs = []
        for i, rec in enumerate(recs):
            q1 = encode_read(rec.read1)
            q2 = encode_read(rec.read2)
            pairs.append((q1, q2, all_regs[2 * i] if len(q1) else [],
                          all_regs[2 * i + 1] if len(q2) else []))
        self.rescue_pairs_batch(pairs, score_delta,
                                local_align_fn=self.local_align_device)
        cache = getattr(self, "_pair_cache", None)
        if cache is None:
            cache = {}
            self._pair_cache = cache
        for rec, (q1, q2, regs1, regs2) in zip(recs, pairs):
            cache[id(rec)] = self.finish_pair(q1, q2, regs1, regs2,
                                              score_delta, skip_rescue=True)

    def align1(self, q: np.ndarray) -> List[AlnReg]:
        """Single-read path routed through the batch machinery."""
        if len(q) == 0:
            return []
        seq = bytes(b"ACGTN"[min(c, 4)] for c in q)
        return self.align_batch([seq])[0]

    # -------------------------------------------------- batched mem_reg2aln

    def reg2aln_batch(self, tasks: List[Tuple[bytes, Optional[AlnReg]]]
                      ) -> List[SingleReadAlignment]:
        """mem_reg2aln for many (read, region) tasks with batched global DP.

        Bit-identical to calling ``reg2aln`` per task (the w2 band ladder is
        replayed with batched waves). Preferred path: C++ session
        (native/align1.cpp r2s_*) runs ladder + NM/clip finishing with the
        banded global DP + on-device traceback as device waves; the Python
        ladder below is the fallback/reference.
        """
        from . import native_engine
        if native_engine.Reg2AlnSession.available():
            out = self._reg2aln_session(tasks)
            if out is not None:
                return out
        return self._reg2aln_python(tasks)

    # Tasks per reg2aln session: a wave's direction-byte buffer is
    # B x Lt x n_col bytes, so the chunk bounds it, while the pipelined
    # driver below keeps every chunk's wave in flight at once.
    R2ALN_CHUNK = 2048

    def _r2s_open(self, tasks):
        """Build one reg2aln session state dict (or a finished one when no
        task needs DP)."""
        from .engine import SingleReadAlignment, encode_read
        from . import native_engine
        n = len(tasks)
        out: List[Optional[SingleReadAlignment]] = [None] * n
        reads = []
        read_key: Dict[int, int] = {}
        rows = []
        live = []
        for idx, (seq, reg) in enumerate(tasks):
            if reg is None or reg.rb < 0 or reg.re < 0:
                out[idx] = SingleReadAlignment()
                continue
            k = read_key.get(id(seq))
            if k is None:
                k = len(reads)
                read_key[id(seq)] = k
                reads.append(encode_read(seq))
            rows.append((k, reg.qb, reg.qe, reg.rb, reg.re, reg.truesc,
                         reg.w))
            live.append(idx)
        st = {"tasks": tasks, "out": out, "rows": rows, "live": live,
              "sess": None, "reads": reads, "reads_res": None}
        if rows:
            st["sess"] = native_engine.Reg2AlnSession(
                self.fm, self.opt, reads, rows)
        return st

    def _global_wave(self, q, qlen, t, tlen, wv):
        """Banded global DP for one wave; returns (result, S) where S is the
        device walk's op-stream length (>= Lq + Lt, a multiple of 4)."""
        from ..ops import sw_global_batch
        opt = self.opt
        n_col = min(q.shape[1], 2 * (opt.band_width << 2) + 1)
        res = sw_global_batch.global_batch(
            q, qlen, t, tlen, np.asarray(self.mat), wv, n_col,
            o_del=opt.gap_open_del, e_del=opt.gap_extend_del,
            o_ins=opt.gap_open_ins, e_ins=opt.gap_extend_ins)
        return res, -(-(q.shape[1] + t.shape[1]) // 4) * 4

    def _r2s_dispatch(self, st):
        """Launch one DP wave for a session; returns async device handles
        plus host-side aux needed to consume them (no transfer happens
        here — downloads pipeline across sessions)."""
        from ..ops import sw_global_batch
        sess = st["sess"]
        tiers = self._tier_plan(max(
            (len(seq) for seq, reg in st["tasks"] if reg is not None),
            default=64))["r2a"]
        t_fill = time.time()
        import os as _os2
        use_res = (_os2.environ.get("LARIAT_NO_RESIDENT") != "1"
                   and hasattr(sess.lib, "r2s_fill_desc"))
        if use_res:
            from ..ops.resident import build_qt, pack_desc, put_reads
            if st["reads_res"] is None:
                st["reads_res"] = put_reads(st["reads"])
            pac_words, l_pac = self._pac_resident()
            descs = sess.wave_descs(**tiers)
            (rid, qstart, qdir, qlen, tstart, tdir, tlen, wv,
             Lq_, Lt_) = descs
            desc = pack_desc(rid, qstart, qdir, qlen, tstart, tdir, tlen,
                             np.zeros_like(wv), wv, l_pac)
            nreal = int(sess.pending())
            (desc,), inv = self._shard_wave(desc, real=nreal)
            q, t = build_qt(st["reads_res"].codes, pac_words, l_pac,
                            desc, Lq=Lq_, Lt=Lt_)
            qlen = desc[:, 3].astype(np.int32)
            tlen = desc[:, 6].astype(np.int32)
            wv = desc[:, 8].astype(np.int32)
        else:
            q, qlen, t, tlen, wv = sess.wave_arrays(**tiers)
            (q, qlen, t, tlen, wv), inv = self._shard_wave(q, qlen, t,
                                                           tlen, wv)
        t_call = time.time()
        res, S = self._global_wave(q, qlen, t, tlen, wv)
        shape = (q.shape[0], q.shape[1], t.shape[1])
        if WAVE_TRACE:
            up_b = (sum(np.asarray(a).nbytes for a in descs[:8])
                    if use_res else
                    sum(np.asarray(a).nbytes for a in (q, t, qlen, tlen, wv)))
            _wtrace("r2a.d", shape, t_call - t_fill, time.time() - t_call,
                    0.0, up_b, 0)
        # one fused download per wave: bit-packed ops + score + cursors
        blob = sw_global_batch.traceback_ops_fused(
            res.z, qlen, tlen, wv, res.score, S=S)
        return (blob, S, inv, shape)

    def _r2s_feed(self, st, handle) -> None:
        """Download a dispatched wave's results and feed the session."""
        from ..ops import sw_global_batch
        blob_h, S, inv, _ = handle
        t_dl = time.time()
        blob = np.asarray(blob_h)
        if inv is not None:
            blob = blob[inv]             # undo the shard round-robin
        if WAVE_TRACE:
            _wtrace("r2a.f", (len(blob),), 0.0, 0.0, time.time() - t_dl, 0,
                    blob.nbytes)
        packed, score, i_fin, k_fin = sw_global_batch.split_traceback_blob(
            blob, S)
        cig_mat, nops = sw_global_batch.cigars_from_ops_packed(
            packed, i_fin, k_fin, S)
        st["sess"].feed(score, cig_mat, nops)

    def _reg2aln_session(self, tasks) -> Optional[List[SingleReadAlignment]]:
        """Chunked + pipelined session driver: every live chunk's wave is
        dispatched before any wave's results are downloaded, so the device
        stays busy and per-wave dispatch latency overlaps across chunks."""
        CH = self.R2ALN_CHUNK
        states = [self._r2s_open(tasks[s:s + CH])
                  for s in range(0, len(tasks), CH)]
        try:
            while True:
                live = [st for st in states
                        if st["sess"] is not None and st["sess"].pending()]
                if not live:
                    break
                t_dev = time.time()
                handles = [(st, self._r2s_dispatch(st)) for st in live]
                for st, h in handles:
                    self._r2s_feed(st, h)
                self._count_wave("r2a", t_dev, [h[-1] for _, h in handles],
                                 n=len(handles))
        finally:
            metas = []
            for st in states:
                sess = st["sess"]
                if sess is not None:
                    try:
                        metas.append(sess.finish())
                    finally:
                        sess.close()
                else:
                    metas.append(None)
        out_all: List[Optional[SingleReadAlignment]] = []
        for st, mc in zip(states, metas):
            if mc is None:
                out_all.extend(st["out"])
                continue
            meta, cig = mc
            self._r2s_fill(st, meta, cig)
            out_all.extend(st["out"])
        return out_all

    def _r2s_fill(self, st, meta, cig) -> None:
        from .engine import SingleReadAlignment
        fm = self.fm
        tasks, rows, live, out = (st["tasks"], st["rows"], st["live"],
                                  st["out"])
        contigs = fm.contigs
        for (_, qb, qe, rb, re, truesc, w), idx, mrow in zip(
                rows, live, meta):
            pos, rid, is_rev, nm, n_pairs, coff = (int(v) for v in mrow)
            flatc = cig[2 * coff:2 * (coff + n_pairs)].tolist()
            cigar = tuple(zip(flatc[0::2], flatc[1::2]))
            reg = tasks[idx][1]
            out[idx] = SingleReadAlignment(
                pos=pos - contigs[rid].offset, rid=rid,
                chrom=contigs[rid].name, reversed_=bool(is_rev),
                edit_distance=nm, cigar=cigar, score=reg.score,
                sub=max(reg.sub, reg.csub), read_s=reg.qb, read_e=reg.qe)

    def _reg2aln_python(self, tasks: List[Tuple[bytes, Optional[AlnReg]]]
                        ) -> List[SingleReadAlignment]:
        """Python ladder replay (executable reference for the session)."""
        from ..ops import sw_global_batch
        from .engine import encode_read
        opt, fm = self.opt, self.fm
        out: List[Optional[SingleReadAlignment]] = [None] * len(tasks)

        @dataclasses.dataclass
        class _G:
            idx: int
            q: np.ndarray            # oriented query codes
            rseq: np.ndarray         # oriented reference codes
            rb: int
            re: int
            truesc: int
            reg_w: int
            w2: int
            last_sc: int = -(1 << 30)
            i: int = 0
            score: int = 0
            cigar: Optional[List[Tuple[int, int]]] = None

        pend: List[_G] = []
        for idx, (seq, reg) in enumerate(tasks):
            if reg is None or reg.rb < 0 or reg.re < 0:
                out[idx] = SingleReadAlignment()
                continue
            query = encode_read(seq)
            qb, qe, rb, re = reg.qb, reg.qe, reg.rb, reg.re
            w2 = max(
                self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                               opt.gap_open_del, opt.gap_extend_del),
                self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                               opt.gap_open_ins, opt.gap_extend_ins))
            if w2 > opt.band_width:
                w2 = min(w2, reg.w)
            qseg = query[qb:qe].astype(np.int64)
            if len(qseg) <= 0 or rb >= re or (rb < fm.l_pac < re):
                out[idx] = self._finish_reg2aln(seq, reg, None, -1)
                continue
            rseq = fm.fetch_fmd(rb, re).astype(np.int64)
            if rb >= fm.l_pac:
                qseg = qseg[::-1].copy()
                rseq = rseq[::-1].copy()
            g = _G(idx=idx, q=qseg, rseq=rseq, rb=rb, re=re,
                   truesc=reg.truesc, reg_w=reg.w, w2=w2)
            pend.append(g)

        while pend:
            # run one ladder step for every pending task, batched by shape
            wave = pend
            pend = []
            run_idx = []
            for g in wave:
                g.w2 = min(g.w2, opt.band_width << 2)
                if len(g.q) == len(g.rseq) and g.w2 == 0:
                    # no-gap shortcut: all-M cigar, summed score
                    g.cigar = [(OP_M, len(g.q))]
                    g.score = int(self.mat[g.rseq, g.q].sum())
                else:
                    run_idx.append(g)
            if run_idx:
                B = len(run_idx)
                Bp = _pow2_bucket(B)
                Lq = max(len(g.q) for g in run_idx)
                Lt = max(len(g.rseq) for g in run_idx)
                Lq = -(-Lq // 64) * 64
                Lt = -(-Lt // 64) * 64
                qa = np.zeros((Bp, Lq), np.int32)
                ta = np.zeros((Bp, Lt), np.int32)
                qlen = np.zeros(Bp, np.int32)
                tlen = np.zeros(Bp, np.int32)
                wv = np.zeros(Bp, np.int32)
                for i, g in enumerate(run_idx):
                    qa[i, :len(g.q)] = g.q
                    ta[i, :len(g.rseq)] = g.rseq
                    qlen[i] = len(g.q)
                    tlen[i] = len(g.rseq)
                    wv[i] = g.w2
                (qa, qlen, ta, tlen, wv), inv = self._shard_wave(
                    qa, qlen, ta, tlen, wv)
                res, S = self._global_wave(qa, qlen, ta, tlen, wv)
                ops_buf, i_fin, k_fin = sw_global_batch.traceback_ops_device(
                    res.z, qlen, tlen, wv, S=S)
                scores = np.asarray(res.score)
                ops_np, ifin_np, kfin_np = (np.asarray(ops_buf),
                                            np.asarray(i_fin),
                                            np.asarray(k_fin))
                if inv is not None:
                    scores = scores[inv]
                    ops_np, ifin_np, kfin_np = (
                        ops_np[inv], ifin_np[inv], kfin_np[inv])
                cigars = sw_global_batch.cigars_from_ops(
                    ops_np, ifin_np, kfin_np)
                for i, g in enumerate(run_idx):
                    g.score = int(scores[i])
                    g.cigar = cigars[i]
            # replay the ladder's break conditions
            for g in wave:
                if (g.score == g.last_sc or g.w2 == opt.band_width << 2):
                    done = True
                else:
                    g.last_sc = g.score
                    g.w2 <<= 1
                    g.i += 1
                    done = not (g.i < 3
                                and g.score < g.truesc - opt.match_score)
                if done:
                    seq, reg = tasks[g.idx]
                    out[g.idx] = self._finish_reg2aln(seq, reg, g.cigar,
                                                      g.score)
                else:
                    pend.append(g)
        return out

    def _finish_reg2aln(self, seq: bytes, reg: AlnReg,
                        cigar: Optional[List[Tuple[int, int]]],
                        score: int) -> SingleReadAlignment:
        """Shared mem_reg2aln tail: NM walk, D squeeze, clips, position."""
        from .engine import encode_read
        opt, fm = self.opt, self.fm
        query = encode_read(seq)
        l_query = len(query)
        qb, qe, rb, re = reg.qb, reg.qe, reg.rb, reg.re
        NM = -1
        if cigar is not None:
            q = query[qb:qe].astype(np.int64)
            rseq = fm.fetch_fmd(rb, re).astype(np.int64)
            if rb >= fm.l_pac:
                q = q[::-1].copy()
                rseq = rseq[::-1].copy()
            n_mm = n_gap = 0
            x = y = 0
            for k, (op, ln) in enumerate(cigar):
                if op == OP_M:
                    n_mm += int(np.count_nonzero(q[x:x + ln] != rseq[y:y + ln]))
                    x += ln
                    y += ln
                elif op == OP_D:
                    if 0 < k < len(cigar) - 1:
                        n_gap += ln
                    y += ln
                else:
                    x += ln
                    n_gap += ln
            NM = n_mm + n_gap
        dpos = rb if rb < fm.l_pac else re - 1
        is_rev = dpos >= fm.l_pac
        pos = (fm.seq_len - 1 - dpos) if is_rev else dpos
        cigar = list(cigar) if cigar else []
        if cigar:
            if cigar[0][0] == OP_D:
                pos += cigar[0][1]
                cigar.pop(0)
            elif cigar[-1][0] == OP_D:
                cigar.pop()
        if qb != 0 or qe != l_query:
            clip5 = l_query - qe if is_rev else qb
            clip3 = qb if is_rev else l_query - qe
            if clip5 > 0:
                cigar.insert(0, (OP_S, clip5))
            if clip3 > 0:
                cigar.append((OP_S, clip3))
        rid = fm.pos_to_contig(pos)
        return SingleReadAlignment(
            pos=int(pos - fm.contigs[rid].offset), rid=rid,
            chrom=fm.contigs[rid].name, reversed_=bool(is_rev),
            edit_distance=int(NM), cigar=tuple(cigar), score=reg.score,
            sub=max(reg.sub, reg.csub), read_s=reg.qb, read_e=reg.qe)
