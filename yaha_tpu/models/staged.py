"""Staged batch engine: native host phases + batched device DP.

The product device path.  All per-read host work — FASTA parse, seed scan,
fragment chaining, clump assembly, perfect extensions, score/split,
OQC/FBS, SAM serialization — runs in the native C++ staged pipeline
(yaha_pipe.cpp yt_batch_*), the counterpart of the reference's
processQueries loop (Query.c:255-497).  Only the two DP phases cross the
host/device boundary, as dense batched problems:

  phase A  anchored gap-fill DPs   (AlignExtFrag.cpp:164-234's DP arm)
  phase B  banded X-drop extensions (SW.cpp:479-533)

Problems within a phase are independent in the reference (their inputs
are fixed before any DP runs), and every DP backend is bit-identical, so
the engine is byte-parity with the per-read pipeline regardless of how
problems are bucketed or which backend serves each bucket.

Small problems (<= 24 rows) run inline on the native small-DP fast paths
during the host phases by default — shipping them to the device costs
more in launch latency than the DP itself; set YT_STAGED_INLINE=0 to
force every problem through the device backend (test coverage).
"""
from __future__ import annotations

import ctypes as ct
import os
import time

import numpy as np

from ..native import host

_u8p = ct.POINTER(ct.c_uint8)
_i32p = ct.POINTER(ct.c_int32)
_i64p = ct.POINTER(ct.c_int64)
_u32p = ct.POINTER(ct.c_uint32)

FMT_NATIVE, FMT_EOIDC, FMT_PACKED, FMT_PACKED_BAND, FMT_RLE = 0, 1, 2, 3, 4

# Device-decode slice bound: rle_decode_* precomputes jump planes with
# a few bytes/cell of transients, so decode runs over problem slices
# holding at most this many plane cells to bound transient memory.
DECODE_MAX_CELLS = 1 << 29

# Largest device problem batch per launch: buckets beyond this split
# into fixed-shape slices (so arbitrarily large chunks reuse ONE
# compiled program instead of growing the pow2 tier ladder), and the
# backtrack-plane d2h transfer stays bounded per launch.
MAX_DEVICE_BATCH = 16384
# Smallest device batch tier (a multiple of the Pallas kernels' block).
MIN_DEVICE_BATCH = 64
# Batch tiers of the Pallas kernels: every distinct shape is a kernel
# compile (seconds each on the GPU), while padded problems cost almost
# nothing (their row loops end at once), so batches pad to one of two
# sizes.
PALLAS_BATCH_TIERS = (1024, MAX_DEVICE_BATCH)
# Widest band tier the band-relative gap-fill kernel serves; wider bands
# (rare) take the full-matrix XLA twin.
GAP_WBAND_MAX = 512


def check_device(backend, interpret=False):
    """The Pallas backend runs compiled GPU kernels only: refuse to
    start when JAX's default backend is not a GPU (interpret mode is a
    test-only switch)."""
    if backend != "pallas" or interpret:
        return
    import jax
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "--engine batch-pallas needs a GPU, but JAX's default backend "
            "is %r; use --engine batch-xla or --engine native on this "
            "machine." % jax.default_backend())


def _sig(lib):
    if getattr(lib, "_staged_sig_done", False):
        return
    lib.yt_batch_begin.restype = ct.c_void_p
    lib.yt_batch_begin.argtypes = [
        _u8p, _i64p, _u8p, _i64p, _u8p, ct.c_int64,
        _u8p, ct.c_int64, ct.c_int64, _i64p, _i64p, ct.c_int64,
        _u8p, _i64p, _u32p, _u32p, ct.c_int64,
        _i64p, ct.POINTER(ct.c_double), ct.c_int64,
        _u32p, _i32p, _i64p, _i64p]
    lib.yt_batch_gap_count.restype = ct.c_int64
    lib.yt_batch_gap_count.argtypes = [ct.c_void_p]
    lib.yt_batch_gap_meta.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                      _i32p]
    lib.yt_batch_gap_meta2.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                       _i64p, _i32p]
    lib.yt_batch_ext_meta2.argtypes = [ct.c_void_p, _i32p, _i32p, _i32p,
                                       _i64p, _i32p]
    lib.yt_batch_gap_fetch.argtypes = [ct.c_void_p, ct.c_int64, _i64p,
                                       _u8p, ct.c_int64, _u8p, ct.c_int64]
    lib.yt_batch_gap_apply.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, _i64p, ct.c_void_p, _i32p,
        ct.c_int64, ct.c_int64, _i32p]
    lib.yt_batch_phase2.argtypes = [ct.c_void_p]
    lib.yt_batch_ext_count.restype = ct.c_int64
    lib.yt_batch_ext_count.argtypes = [ct.c_void_p]
    lib.yt_batch_ext_meta.argtypes = [ct.c_void_p, _i32p, _i32p, _u8p]
    lib.yt_batch_ext_fetch.argtypes = [ct.c_void_p, ct.c_int64, _i64p,
                                       _u8p, ct.c_int64, _u8p, ct.c_int64]
    lib.yt_batch_ext_apply.argtypes = [
        ct.c_void_p, ct.c_int64, ct.c_int64, _i64p, ct.c_void_p, _i32p,
        ct.c_int64, ct.c_int64, _i32p, _i32p, _i32p]
    lib.yt_batch_finish.argtypes = [
        ct.c_void_p, ct.POINTER(ct.c_void_p), _i64p, _i64p, _i64p,
        _i64p]
    lib.yt_batch_query_stats.argtypes = [ct.c_void_p, _i64p, _i64p,
                                         _i64p, _i64p]
    lib.yt_batch_free.argtypes = [ct.c_void_p]
    lib._staged_sig_done = True


def _pow2(x, lo=32):
    return max(lo, 1 << (int(x) - 1).bit_length())


def _pow2_floor(x, lo):
    return max(lo, 1 << (int(x).bit_length() - 1))


def _pow2_arr(x, lo=32, step=1):
    """Per-element next power of two (of 2**step when step > 1),
    floored at `lo` (bucket widths)."""
    x = np.maximum(np.asarray(x, np.int64), 2)
    e = np.ceil(np.log2(x.astype(np.float64)) / step).astype(np.int64)
    return np.maximum(np.int64(lo), np.int64(1) << (step * e))


def _pallas_batch(n):
    """Padded batch size for a Pallas kernel launch of n problems."""
    return next(t for t in PALLAS_BATCH_TIERS if n <= t)


def decode_plan(bounds_sorted, n, sl, max_iters):
    """Slice plan for the on-device RLE decode over walk-bound-sorted
    problems: [(start, L, lo, hi, mi)] where rows [lo, hi) of the sorted
    plane are decoded by a window of L = min(sl, n) rows beginning at
    `start` (overlapping BACKWARD into smaller-bound rows, so every
    slice of a plane shares one compiled program) with a pow2 per-slice
    iteration bound `mi`.  The decode's three stages (jump-plane prefix ops amortize,
    but the walk loop and the stable-sort compaction both cost
    O(rows x mi)) all rode the tier-wide static bound before; production
    batches are dominated by X-drop-killed junk extensions whose walks
    end within a few dozen rows, so bucketing mi by the host-known walk
    bound (2*maxi + w + 2 for extensions — the same formula as the
    static bound with the walk's true row span) removes most of that
    work."""
    plan = []
    i = 0
    while i < n:
        mi = min(_pow2(max(int(bounds_sorted[i]), 1), 64), max_iters)
        j = int(np.searchsorted(bounds_sorted, mi, side="right"))
        j = max(j, i + 1)
        for lo in range(i, j, sl):
            hi = min(lo + sl, j)
            L = min(sl, n)
            start = max(0, hi - L)
            plan.append((start, L, lo, hi, mi))
        i = j
    return plan


def _p32(a):
    return a.ctypes.data_as(_i32p)


def _p64(a):
    return a.ctypes.data_as(_i64p)


def _pu8(a):
    return a.ctypes.data_as(_u8p)


class StagedAligner:
    """Batch aligner over ParsedReads with device DP phases.

    backend: 'pallas' (Pallas GPU kernels), 'xla' (jit twins — run on
    whatever device jax selected), or 'native' (host C++ DP; the staging
    harness with zero device involvement, used for A/B validation).
    interpret=True runs the Pallas kernels in interpret mode, so the
    whole staged-pallas path (kernels + device decode + FMT_RLE apply)
    is testable without a GPU; only tests pass it.
    """

    def __init__(self, aa, genome, index, backend="pallas", n_threads=1,
                 inline_small=None, seeder=None, interpret=False):
        check_device(backend, interpret)
        self.aa = aa
        self.genome = genome
        self.index = index
        self.backend = backend
        # Optional device seed phase (models/seeder.DeviceSeeder): the
        # composed product x scale-out path — seed lookup on the (data x
        # model) mesh against the ShardedIndex, hits fed to the native
        # chaining (yt_hits_to_clumps) with zero per-read Python.
        self.seeder = seeder
        self.n_threads = max(1, int(n_threads))
        if inline_small is None:
            inline_small = os.environ.get("YT_STAGED_INLINE", "1") != "0"
        self.inline_small = inline_small
        # On-device run-length backtrack decode (ops/decode_jax.py): the
        # walk runs on the device and only the (op, len) items transfer —
        # the packed planes never leave device memory.  YT_STAGED_RLE=0
        # falls back to plane transfer + host walk (A/B validation).
        self.rle = os.environ.get("YT_STAGED_RLE", "1") != "0"
        self.interpret = interpret
        self.lib = host._load()
        _sig(self.lib)
        # Device-resident problem assembly (ops/gather_dp.py): genome
        # codes live in device memory for the whole run, the chunk's
        # read codes upload once per chunk, and each DP bucket's (q, r)
        # planes are gathered on device from ~26 B/problem of
        # coordinates (yt_batch_*_meta2) instead of uploaded.
        # YT_STAGED_DEVRES=0 restores host fetch.
        self.corpus = None
        if (backend in ("xla", "pallas")
                and os.environ.get("YT_STAGED_DEVRES", "1") != "0"
                and hasattr(genome, "codes_buf")):
            from ..ops.gather_dp import DeviceCorpus
            codes_np = np.ctypeslib.as_array(
                ct.cast(genome.codes_buf, _u8p),
                shape=(int(genome.codes_len),))
            self.corpus = DeviceCorpus(codes_np)
            from ..utils import codec
            self._code_tab = np.asarray(codec.FOUR_BIT_CODES, np.uint8)
        # Launch/byte accounting for the e2e cost decomposition:
        # device launches and h2d/d2h problem bytes.
        self.stats = {"dp_launches": 0, "h2d_bytes": 0, "d2h_bytes": 0,
                      "gap_problems": 0, "ext_problems": 0,
                      "gap_cells": 0, "ext_cells": 0, "device_s": 0.0,
                      # Split of device_s on the pallas backend: problem
                      # gather + DP kernel up to the score fetch, then
                      # the RLE decode and its item transfer.
                      "dp_kernel_s": 0.0, "dp_decode_s": 0.0,
                      # Gap dispatch classes on the pallas backend: the
                      # band-relative kernel (wband <= GAP_WBAND_MAX)
                      # vs the full-matrix XLA twin.  Per-tier counts of
                      # the kernel's problems go under gap_w<wband>.
                      "gap_banded": 0, "gap_fallback": 0,
                      # Host-phase decomposition: native stage walls +
                      # Python-side problem marshalling.
                      "begin_s": 0.0, "gap_host_s": 0.0, "phase2_s": 0.0,
                      "ext_host_s": 0.0, "finish_s": 0.0}
        # align_chunk may run concurrently from the CLI's prefetch
        # pipeline (chunk k+1 host phases overlap chunk k device waits);
        # the accumulator guards the read-modify-write.
        import threading
        self._stats_lock = threading.Lock()
        self.buckets = []

    def _log_bucket(self, phase, qg, rg, band, n, seconds):
        """One record per device DP launch (bench.py reads them):
        phase, row/column tiers, band width, problems, wall seconds of
        the launch including its decode and transfers."""
        with self._stats_lock:
            self.buckets.append((phase, qg, rg, band, n, seconds))

    def _acc(self, **kv):
        with self._stats_lock:
            for k, v in kv.items():
                self.stats[k] = self.stats.get(k, 0) + v

    # ---- DP backends ----

    def _device_rle(self, bt, y0, x0, active, cap, max_iters,
                    walk_bounds):
        """Run the on-device RLE walk (decode_jax.rle_decode_rows) over
        problem slices of a problem-minor plane [h, w, N] (bounding the
        jump-plane transient memory); returns (rle device [nr, cap], n_ops
        host [N], row_map [N]).

        `walk_bounds` (host ints) are per-problem iteration upper bounds:
        problems are decoded in ascending-bound slices, each with a pow2
        bound mi << max_iters (see decode_plan), so the slices that hold
        X-drop-killed junk end after a few dozen iterations.  row_map[p]
        is the rle row holding problem p (slices may overlap, so the rle
        can have more rows than problems)."""
        import jax.numpy as jnp
        from ..ops.decode_jax import rle_decode_rows
        h, w, np_ = bt.shape
        order = np.argsort(walk_bounds, kind="stable").astype(np.int32)
        sl = min(_pow2_floor(max(1, DECODE_MAX_CELLS // max(1, h * w)),
                             1024), np_)
        plan = decode_plan(walk_bounds[order], np_, sl, max_iters)
        y0, x0, active = (jnp.asarray(a) for a in (y0, x0, active))
        outs, counts = [], []
        row_sorted = np.empty(np_, np.int64)
        off = 0
        for start, L, lo, hi, mi in plan:
            r, c = rle_decode_rows(bt, order[start:start + L], y0, x0,
                                   active, np.int32(mi), cap=cap)
            outs.append(r)
            counts.append(c)
            row_sorted[lo:hi] = off + (np.arange(lo, hi) - start)
            off += L
        rle = outs[0] if len(outs) == 1 else jnp.concatenate(outs)
        cnt = counts[0] if len(counts) == 1 else jnp.concatenate(counts)
        cnt_sorted = np.asarray(cnt)[row_sorted]   # one blocking d2h
        # The walk flags a walk still active at its iteration bound with
        # n_ops = -1; the bounds are structural (2*rows + band + 2) so
        # this must never fire — fail loud rather than emit a truncated
        # EditOpList.
        if cnt_sorted.min(initial=0) < 0:
            raise RuntimeError(
                "on-device RLE walk truncated (max_iters bound too "
                "small): plan=%r" % ([p[4] for p in plan],))
        row_map = np.empty(np_, np.int64)
        row_map[order] = row_sorted
        cnt = np.empty(np_, cnt_sorted.dtype)
        cnt[order] = cnt_sorted
        return rle, cnt, row_map

    def _rle_parts(self, rle_dev, nops, n, cap, row_map=None):
        """Tier-compact device RLE rows by per-problem item count before
        d2h (the ops-count twin of the row-tier plane compaction), as a
        SINGLE ragged device gather + one transfer — per-tier transfers
        would each pay a blocking round trip; yields
        (lidx, items array, tier).  `row_map[p]` = rle row of problem p
        (identity when the decode ran unsorted)."""
        from ..ops import decode_jax
        tiers = np.minimum(_pow2_arr(np.maximum(nops[:n], 1), 8), cap)
        order = np.argsort(tiers, kind="stable")
        t_sorted = tiers[order]
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(t_sorted, out=starts[1:])
        total = int(starts[n])
        total_pad = _pow2(total, 1024)
        n_pad = _pow2(n, 256)
        src_aug = np.zeros(n_pad + 1, np.int32)
        src_aug[:n] = order if row_map is None else row_map[order]
        t_aug = np.zeros(n_pad + 1, np.int64)
        t_aug[:n] = t_sorted
        t_aug[n_pad] = total_pad - total
        starts_aug = np.full(n_pad + 1, total, np.int64)
        starts_aug[:n] = starts[:n]
        flat = decode_jax.gather_rle_flat(rle_dev, src_aug, t_aug,
                                          starts_aug, cap=cap,
                                          total_pad=total_pad)
        arr = np.asarray(flat)
        self._acc(d2h_bytes=(4 * total + 4 * n))
        parts = []
        g0 = 0
        while g0 < n:
            t = int(t_sorted[g0])
            g1 = int(np.searchsorted(t_sorted, t, side="right"))
            block = arr[int(starts[g0]):int(starts[g1])]
            parts.append((order[g0:g1], block.reshape(g1 - g0, t), t))
            g0 = g1
        return parts

    def _run_gap_bucket(self, qa, qlens, ra, rlens, lbws, rbws,
                        qg=None, rg=None, dev_gather=None):
        """Returns a list of result parts
        [(local_idx, format, plane, idc, plane_stride, row_stride,
          score)]; arrays stay alive via the returned tuples.
        `dev_gather(mpad)`, when given, assembles the (q, r)
        planes on device (qa/ra are None then)."""
        aa = self.aa
        kw = dict(go=aa.go_cost, ge=aa.ge_cost, rc=aa.r_cost,
                  ms=aa.m_score, max_gap=aa.max_gap,
                  max_intron=aa.max_intron)
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        wband_need = int((lbws + rbws).max()) + 1
        wband = _pow2(wband_need)
        self._acc(dp_launches=(1))
        if dev_gather is None:
            self._acc(h2d_bytes=(n * (qg + rg)))
        else:
            self._acc(h2d_bytes=(26 * n))   # coordinates only
        t0 = time.time()
        if self.backend == "pallas" and wband <= GAP_WBAND_MAX:
            from ..ops import sw_pallas
            self._acc(gap_banded=n, **{"gap_w%d" % wband: n})
            pad = _pallas_batch(n) - n
            ql_p = np.pad(qlens, (0, pad))
            rl_p = np.pad(rlens, (0, pad))
            lb_p = np.pad(lbws, (0, pad))
            if dev_gather is not None:
                qd, rd = dev_gather(n + pad)
            else:
                qd = np.pad(qa, ((0, pad), (0, 0)))
                rd = np.pad(ra, ((0, pad), (0, 0)))
            out = sw_pallas.anchored_forward_pallas_banded(
                qd, ql_p, rd, rl_p, lb_p, np.pad(rbws, (0, pad)),
                wband=wband, interpret=self.interpret, **kw)
            bt_dev = out["bt_b"]
            score = np.ascontiguousarray(
                np.asarray(out["score"])[:n].astype(np.int32))
            t_k = time.time()
            self._acc(dp_kernel_s=t_k - t0)
            if self.rle:
                x0 = (rl_p - ql_p + lb_p).astype(np.int32)
                bound = 2 * qg + wband + 2
                cap = _pow2(bound, 32)
                # Anchored walks start at (qlen, rlen): the per-problem
                # iteration bound rides qlen, so sort by it (decode_plan).
                wb = 2 * ql_p.astype(np.int64) + wband + 2 + 16
                rle_dev, nops, rmap = self._device_rle(
                    bt_dev, ql_p.astype(np.int32), x0,
                    np.ones(len(ql_p), bool), cap, bound + 16, wb)
                parts = []
                for lidx, arr, t in self._rle_parts(rle_dev, nops, n,
                                                    cap, rmap):
                    parts.append(
                        (lidx, FMT_RLE, arr,
                         np.ascontiguousarray(nops[lidx].astype(np.int32)),
                         t, 0, np.ascontiguousarray(score[lidx])))
                self._acc(device_s=(time.time() - t0),
                          dp_decode_s=(time.time() - t_k))
                self._acc(d2h_bytes=(score.nbytes))
                return parts
            bt = np.ascontiguousarray(
                np.asarray(sw_pallas.problem_major(bt_dev))[:n])
            self._acc(device_s=(time.time() - t0))
            self._acc(d2h_bytes=(bt.nbytes + score.nbytes))
            return [(np.arange(n), FMT_PACKED_BAND, bt, None,
                     bt.shape[1] * bt.shape[2], wband, score)]
        if self.backend == "pallas":
            # Bands wider than GAP_WBAND_MAX: the full-matrix XLA twin.
            self._acc(gap_fallback=n)
        if self.backend == "native":
            out = host.anchored_forward(qa, qlens.astype(np.int64), ra,
                                        rlens.astype(np.int64),
                                        lbws.astype(np.int64),
                                        rbws.astype(np.int64), **kw)
        else:
            from ..ops import sw_batch
            # Pad the batch dim to a power-of-two tier so jit compiles a
            # bounded set of shapes across chunks (pad rows are valid
            # 1x1 problems; their results are sliced away).
            pad = _pow2(n, MIN_DEVICE_BATCH) - n
            if dev_gather is not None:
                qa_d, ra_d = dev_gather(n + pad)
            else:
                qa_d = np.pad(qa, ((0, pad), (0, 0)))
                ra_d = np.pad(ra, ((0, pad), (0, 0)))
            out = sw_batch.batched_anchored_forward(
                qa_d, np.pad(qlens, (0, pad), constant_values=1),
                ra_d, np.pad(rlens, (0, pad), constant_values=1),
                np.pad(lbws, (0, pad), constant_values=1),
                np.pad(rbws, (0, pad), constant_values=1), **kw)
            out = {k: np.asarray(v) for k, v in out.items()}
        eo = np.ascontiguousarray(out["eo"][:n])
        idc = np.ascontiguousarray(out["idc"][:n].astype(np.int32))
        score = np.ascontiguousarray(out["score"][:n].astype(np.int32))
        self._acc(device_s=(time.time() - t0))
        self._acc(d2h_bytes=(eo.nbytes + idc.nbytes + score.nbytes))
        return [(np.arange(n), FMT_EOIDC, eo, idc,
                 eo.shape[1] * eo.shape[2], eo.shape[2], score)]

    def _run_ext_bucket(self, qa, qlens, ra, rlens, qg=None, rg=None,
                        dev_gather=None):
        """Returns a list of result parts
        [(local_idx, fmt, plane, idc, plane_stride, row_stride,
          maxi, maxj, score)].  `dev_gather(mpad)`, when given,
        assembles the (q, r) planes on device (qa/ra are None then)."""
        aa = self.aa
        kw = dict(band_width=aa.band_width, go=aa.go_cost, ge=aa.ge_cost,
                  rc=aa.r_cost, ms=aa.m_score, max_gap=aa.max_gap,
                  max_intron=aa.max_intron, x_cutoff=aa.x_cutoff)
        n = len(qlens)
        if qg is None:
            qg, rg = qa.shape[1], ra.shape[1]
        self._acc(dp_launches=(1))
        if dev_gather is None:
            self._acc(h2d_bytes=(n * (qg + rg)))
        else:
            self._acc(h2d_bytes=(26 * n))   # coordinates only
        t0 = time.time()
        if self.backend == "pallas":
            from ..ops import sw_pallas
            pad = _pallas_batch(n) - n
            if dev_gather is not None:
                qd, rd = dev_gather(n + pad)
            else:
                qd = np.pad(qa, ((0, pad), (0, 0)))
                rd = np.pad(ra, ((0, pad), (0, 0)), constant_values=255)
            out = sw_pallas.extension_forward_pallas(
                qd, np.pad(qlens, (0, pad)), rd, np.pad(rlens, (0, pad)),
                interpret=self.interpret, **kw)
            smm = np.stack([np.asarray(out[k])
                            for k in ("score", "maxi", "maxj")])
            score = np.ascontiguousarray(smm[0, :n].astype(np.int32))
            maxi = np.ascontiguousarray(smm[1, :n].astype(np.int32))
            maxj = np.ascontiguousarray(smm[2, :n].astype(np.int32))
            t_k = time.time()
            self._acc(dp_kernel_s=t_k - t0)
            # On-device run-length decode: the plane never leaves the
            # device; only (op, len) items transfer, tier-compacted by
            # per-problem item count.  Row tiers beyond 16k fall back to
            # the plane path: the decode's jump-plane transients scale
            # with rows x slice width.
            if self.rle and qg <= 16384:
                w = out["bt"].shape[1]
                bound = 2 * qg + w + 2
                cap = _pow2(bound, 32)
                # Walk-bound-sorted decode slices: ascending maxi (the
                # walk's row bound) groups X-drop-killed junk together,
                # and per-slice pow2 iteration bounds (2*maxi + w + 2,
                # the static formula with the true row span) let those
                # slices' walk loops AND sort compactions run dozens of
                # iterations instead of the tier bound (decode_plan).
                wb = (2 * smm[1].astype(np.int64) + w + 2 + 16)
                rle_dev, nops, rmap = self._device_rle(
                    out["bt"], out["maxi"], out["maxj"], out["score"] > 0,
                    cap, bound + 16, wb)
                parts = []
                for lidx, arr, t in self._rle_parts(rle_dev, nops, n,
                                                    cap, rmap):
                    parts.append(
                        (lidx, FMT_RLE, arr,
                         np.ascontiguousarray(nops[lidx].astype(np.int32)),
                         t, 0,
                         np.ascontiguousarray(maxi[lidx]),
                         np.ascontiguousarray(maxj[lidx]),
                         np.ascontiguousarray(score[lidx])))
                self._acc(device_s=(time.time() - t0),
                          dp_decode_s=(time.time() - t_k))
                self._acc(d2h_bytes=(12 * n))
                return parts
            # Per-problem plane compaction before d2h: the backtrack
            # walks DOWN from (maxi, maxj), so a problem only needs
            # rows [0, maxi].  Problems group into pow2 row tiers; each
            # tier's planes are gathered on-device and transferred
            # trimmed.  (Gather/slice shapes are pow2-tiered like
            # everything else so the compiled-program set stays
            # bounded.)
            import jax.numpy as jnp
            bt_dev = sw_pallas.problem_major(out["bt"])
            plane_rows = bt_dev.shape[1]
            need = np.minimum(maxi.astype(np.int64) + 1, plane_rows)
            tiers = _pow2_arr(need, 64)
            tiers = np.minimum(tiers, plane_rows)
            parts = []
            for t in np.unique(tiers):
                lidx = np.nonzero(tiers == t)[0]
                lp = _pow2(len(lidx), 256)
                pad_idx = np.zeros(lp, np.int32)
                pad_idx[:len(lidx)] = lidx
                sub = jnp.take(bt_dev, jnp.asarray(pad_idx),
                               axis=0)[:, :int(t), :]
                btp = np.ascontiguousarray(
                    np.asarray(sub)[:len(lidx)])
                self._acc(d2h_bytes=(btp.nbytes))
                parts.append((lidx, FMT_PACKED, btp, None,
                              btp.shape[1] * btp.shape[2], btp.shape[2],
                              np.ascontiguousarray(maxi[lidx]),
                              np.ascontiguousarray(maxj[lidx]),
                              np.ascontiguousarray(score[lidx])))
            self._acc(device_s=(time.time() - t0))
            self._acc(d2h_bytes=(12 * n))
            return parts
        if self.backend == "native":
            out = host.extension_forward(qa, qlens.astype(np.int64), ra,
                                         rlens.astype(np.int64), **kw)
            out = {k: np.asarray(v) for k, v in out.items()}
        else:
            from ..ops import sw_batch
            pad = _pow2(n, MIN_DEVICE_BATCH) - n   # stable jit tiers
            if dev_gather is not None:
                qa_d, ra_d = dev_gather(n + pad)
            else:
                qa_d = np.pad(qa, ((0, pad), (0, 0)))
                ra_d = np.pad(ra, ((0, pad), (0, 0)),
                              constant_values=255)
            out = sw_batch.batched_extension_forward(
                qa_d, np.pad(qlens, (0, pad), constant_values=1),
                ra_d, np.pad(rlens, (0, pad),
                             constant_values=1 + 2 * aa.band_width),
                **kw)
            out = {k: np.asarray(v) for k, v in out.items()}
        eo = np.ascontiguousarray(out["eo"][:n])
        idc = np.ascontiguousarray(out["idc"][:n].astype(np.int32))
        score = np.ascontiguousarray(out["score"][:n].astype(np.int32))
        maxi = np.ascontiguousarray(out["maxi"][:n].astype(np.int32))
        maxj = np.ascontiguousarray(out["maxj"][:n].astype(np.int32))
        self._acc(device_s=(time.time() - t0))
        self._acc(d2h_bytes=(eo.nbytes + idc.nbytes + 12 * n))
        return [(np.arange(n), FMT_EOIDC, eo, idc,
                 eo.shape[1] * eo.shape[2], eo.shape[2], maxi, maxj,
                 score)]

    # ---- phase drivers ----

    def _chunk_rows(self, pr, lo, hi):
        """Upload the chunk's forward code rows (one vectorized pass
        over the parsed reads); the device derives the revcomp rows.
        Shapes are pow2-tiered so the gather programs stay cached."""
        n = hi - lo
        offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
        total = int(offs[pr.n])
        seqs = np.ctypeslib.as_array(pr.seqs, shape=(max(total, 1),))
        lens = (offs[lo + 1:hi + 1] - offs[lo:hi]).astype(np.int64)
        lmax = int(lens.max()) if n else 1
        lpad = _pow2(max(lmax, 64), 64)
        npad = _pow2(n, 256)
        fwd = np.full((npad, lpad), 4, np.uint8)
        seg0, seg1 = int(offs[lo]), int(offs[hi])
        if seg1 > seg0:
            codes = self._code_tab[seqs[seg0:seg1]]
            row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
            pos = (np.arange(seg1 - seg0, dtype=np.int64) -
                   np.repeat((offs[lo:hi] - seg0).astype(np.int64),
                             lens))
            fwd.reshape(-1)[row_of * lpad + pos] = codes
        lens_p = np.zeros(npad, np.int32)
        lens_p[:n] = lens
        self._acc(h2d_bytes=(fwd.nbytes // 2 + lens_p.nbytes))
        return self.corpus.chunk_rows(fwd, lens_p)

    def _meta2(self, ctx, n, fn):
        """Fetch the device-assembly coordinates for a phase."""
        q_row = np.empty(n, np.int32)
        q_src = np.empty(n, np.int32)
        q_copy = np.empty(n, np.int32)
        r_src = np.empty(n, np.int64)
        r_copy = np.empty(n, np.int32)
        fn(ctx, _p32(q_row), _p32(q_src), _p32(q_copy), _p64(r_src),
           _p32(r_copy))
        return q_row, q_src, q_copy, r_src, r_copy

    def _mk_gather(self, rows2, meta2, idx, qlen, rlen, rev, rpad,
                   qg, rg):
        """Device plane assembler for one bucket slice: pads the
        coordinate arrays to the caller's tier and gathers on device."""
        q_row, q_src, q_copy, r_src, r_copy = meta2

        def g(mpad, _i=idx):
            mp = mpad - len(_i)
            pz = lambda a: np.pad(a[_i], (0, mp))
            return self.corpus.gather(
                rows2, pz(q_row), pz(q_src), pz(q_copy), pz(qlen),
                pz(r_src), pz(r_copy), pz(rlen),
                pz(rev) if rev is not None else None,
                qg=qg, rg=rg, rpad=rpad)
        return g

    def _gap_phase(self, ctx, rows2=None):
        lib = self.lib
        n = int(lib.yt_batch_gap_count(ctx))
        self._acc(gap_problems=(n))
        if n == 0:
            return
        if self.backend == "native" and self.inline_small:
            # Zero-marshalling host path.
            lib.yt_batch_gap_apply(ctx, FMT_NATIVE, 0, None, None, None,
                                   0, 0, None)
            return
        qlen = np.empty(n, np.int32)
        rlen = np.empty(n, np.int32)
        lbw = np.empty(n, np.int32)
        rbw = np.empty(n, np.int32)
        lib.yt_batch_gap_meta(ctx, _p32(qlen), _p32(rlen), _p32(lbw),
                              _p32(rbw))
        meta2 = None
        if rows2 is not None:
            meta2 = self._meta2(ctx, n, lib.yt_batch_gap_meta2)
        qb = _pow2_arr(qlen)
        rb = _pow2_arr(rlen)
        keys = (qb << 32) | rb
        from ..ops.gather_dp import PAGE_OVERLAP
        for key in np.unique(keys):
            bidx = np.nonzero(keys == key)[0].astype(np.int64)
            qg = int(key >> 32)
            rg = int(key & 0xFFFFFFFF)
            use_dev = meta2 is not None and rg <= PAGE_OVERLAP
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = ra = dev_gather = None
                if use_dev:
                    dev_gather = self._mk_gather(
                        rows2, meta2, idx, qlen, rlen, None, 0, qg, rg)
                else:
                    qa = np.zeros((m, qg), np.uint8)
                    ra = np.zeros((m, rg), np.uint8)
                    lib.yt_batch_gap_fetch(ctx, m, _p64(idx), _pu8(qa),
                                           qg, _pu8(ra), rg)
                ql_b = qlen[idx].astype(np.int64)
                rl_b = rlen[idx].astype(np.int64)
                lb_b = lbw[idx].astype(np.int64)
                rb_b = rbw[idx].astype(np.int64)
                self._acc(gap_cells=int(
                    (np.minimum(lb_b + rb_b + 1, rl_b + 1) * ql_b).sum()))
                t_b = time.time()
                parts = self._run_gap_bucket(qa, ql_b, ra, rl_b, lb_b, rb_b,
                                             qg=qg, rg=rg,
                                             dev_gather=dev_gather)
                self._log_bucket("gap", qg, rg, _pow2(int(
                    (lb_b + rb_b).max()) + 1), m, time.time() - t_b)
                for (lidx, fmt, plane, idc, pstride, rstride,
                     score) in parts:
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_gap_apply(
                        ctx, fmt, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p),
                        _p32(idc) if idc is not None else None,
                        pstride, rstride, _p32(score))

    def _ext_phase(self, ctx, rows2=None):
        lib = self.lib
        n = int(lib.yt_batch_ext_count(ctx))
        self._acc(ext_problems=(n))
        if n == 0:
            return
        if self.backend == "native" and self.inline_small:
            lib.yt_batch_ext_apply(ctx, FMT_NATIVE, 0, None, None, None,
                                   0, 0, None, None, None)
            return
        qlen = np.empty(n, np.int32)
        rlen = np.empty(n, np.int32)
        rev = np.empty(n, np.uint8)
        lib.yt_batch_ext_meta(ctx, _p32(qlen), _p32(rlen), _pu8(rev))
        meta2 = None
        if rows2 is not None:
            meta2 = self._meta2(ctx, n, lib.yt_batch_ext_meta2)
        bw2 = 2 * self.aa.band_width
        # The Pallas kernel's row loop ends at its block's longest query,
        # so it takes coarser (power-of-4) row tiers: fewer compiles.
        qb = _pow2_arr(qlen, 64, 2) if self.backend == "pallas" else \
            _pow2_arr(qlen)
        from ..ops.gather_dp import PAGE_OVERLAP
        for key in np.unique(qb):
            bidx = np.nonzero(qb == key)[0].astype(np.int64)
            qg = int(key)
            rg = qg + 2 * bw2
            use_dev = meta2 is not None and rg <= PAGE_OVERLAP
            for lo in range(0, len(bidx), MAX_DEVICE_BATCH):
                idx = np.ascontiguousarray(bidx[lo:lo + MAX_DEVICE_BATCH])
                m = len(idx)
                qa = ra = dev_gather = None
                if use_dev:
                    dev_gather = self._mk_gather(
                        rows2, meta2, idx, qlen, rlen, rev, 255, qg, rg)
                else:
                    qa = np.zeros((m, qg), np.uint8)
                    ra = np.full((m, rg), 255, np.uint8)
                    lib.yt_batch_ext_fetch(ctx, m, _p64(idx), _pu8(qa),
                                           qg, _pu8(ra), rg)
                ql_b = qlen[idx].astype(np.int64)
                rl_b = rlen[idx].astype(np.int64)
                self._acc(ext_cells=int(
                    (ql_b * (2 * bw2 + 1)).sum()))
                t_b = time.time()
                parts = self._run_ext_bucket(qa, ql_b, ra, rl_b, qg=qg,
                                             rg=rg, dev_gather=dev_gather)
                self._log_bucket("ext", qg, rg, 2 * bw2 + 1, m,
                                 time.time() - t_b)
                for (lidx, fmt, plane, idc, pstride, rstride, maxi,
                     maxj, score) in parts:
                    gidx = np.ascontiguousarray(idx[lidx])
                    lib.yt_batch_ext_apply(
                        ctx, fmt, len(gidx), _p64(gidx),
                        plane.ctypes.data_as(ct.c_void_p),
                        _p32(idc) if idc is not None else None,
                        pstride, rstride, _p32(maxi), _p32(maxj),
                        _p32(score))

    # ---- driver ----

    def align_chunk(self, pr, lo: int, hi: int, dist=None,
                    want_stats=False):
        """Align reads [lo, hi) of a ParsedReads through the staged
        pipeline; returns (sam_bytes, seed_matches, records).  `dist`,
        if given, is a ctypes (c_int64 * 11) array filled with the
        per-batch STATS distributions (same fields as
        host.align_batch_native).  `want_stats` appends a fourth
        return: the QUERYSTATS TSV rows (-qs; Query.c:480-491), with
        per-read usec measured inside the native phases (batched
        device kernel time excluded — not per-read attributable)."""
        lib = self.lib
        aa = self.aa
        genome = self.genome
        index = self.index
        ip, fp = host._pack_params_ct(aa, self.n_threads)

        def off64(p, k):
            return ct.cast(ct.cast(p, ct.c_void_p).value + 8 * k, _i64p)

        import time as _t0mod
        t_begin = _t0mod.time()
        t_chunk0 = t_begin
        seeds = None
        if self.seeder is not None:
            # Device seed phase: hits arrive sorted by (diag, qo) per
            # (read, strand) row; rows that overflowed the top capacity
            # tier carry total -1 and take the host scan inside phase 1.
            seeds = self.seeder.seed_chunk(pr, lo, hi, self)
            # The seed wall is already accounted in seeder.stats
            # ['seed_device_s']; exclude it from begin_s so the host
            # decomposition doesn't double-count it.
            t_begin = _t0mod.time()
        rows2 = None
        if self.corpus is not None:
            # Dispatch the chunk-codes upload BEFORE the native phase-1
            # so the h2d overlaps the seed/chain/assembly host work; the
            # dispatch cost counts as device time (on a local chip the
            # packed upload is sub-ms DMA).
            t_up = _t0mod.time()
            rows2 = self._chunk_rows(pr, lo, hi)
            dt_up = _t0mod.time() - t_up
            self._acc(device_s=dt_up)
            t_begin += dt_up
        ctx = lib.yt_batch_begin(
            pr.seqs, off64(pr.seq_offs, lo), pr.ids,
            off64(pr.id_offs, lo), pr.quals if aa.fastq else None,
            hi - lo,
            ct.cast(genome.codes_buf, _u8p), genome.codes_len,
            genome.max_roff,
            ct.cast(genome._starts_arr, _i64p),
            ct.cast(genome._lens_arr, _i64p), genome.n_seqs,
            ct.cast(genome._names_blob, _u8p),
            ct.cast(genome._name_offs, _i64p),
            index.so_ptr, index.roa_ptr, index.roa_len,
            ct.cast(ip, _i64p), ct.cast(fp, ct.POINTER(ct.c_double)),
            1 if self.inline_small else 0,
            seeds[0].ctypes.data_as(_u32p) if seeds else None,
            _p32(seeds[1]) if seeds else None,
            _p64(seeds[2]) if seeds else None,
            _p64(seeds[3]) if seeds else None)
        if not ctx:
            raise RuntimeError("yt_batch_begin failed")
        try:
            import time as _t
            t1 = _t.time()
            self._acc(begin_s=(t1 - t_begin))
            d0 = self.stats["device_s"]
            self._gap_phase(ctx, rows2)
            t2 = _t.time()
            d1 = self.stats["device_s"]
            self._acc(gap_host_s=(t2 - t1 - (d1 - d0)))
            lib.yt_batch_phase2(ctx)
            t3 = _t.time()
            self._acc(phase2_s=(t3 - t2))
            self._ext_phase(ctx, rows2)
            t4 = _t.time()
            d2 = self.stats["device_s"]
            self._acc(ext_host_s=(t4 - t3 - (d2 - d1)))
            out_text = ct.c_void_p()
            out_len = ct.c_int64()
            sm = ct.c_int64()
            nr = ct.c_int64()
            rc = lib.yt_batch_finish(
                ctx, ct.byref(out_text), ct.byref(out_len),
                ct.byref(sm), ct.byref(nr),
                ct.cast(dist, _i64p) if dist is not None else None)
            self._acc(finish_s=(_t.time() - t4))
            assert rc == 0
            try:
                text = ct.string_at(out_text, out_len.value)
            finally:
                lib.yt_free(out_text)
            if want_stats:
                # Per-read usec measured inside the native phases
                # (phase1/2/3 + per-problem DP inline/decode time,
                # yt_batch_query_stats).  Batched device kernel time is
                # not per-read attributable and is excluded — on the
                # staged native backend (DP inline) the column carries
                # the per-read engine's semantics.
                n = hi - lo
                ql = np.empty(n, np.int64)
                sd = np.empty(n, np.int64)
                al = np.empty(n, np.int64)
                us = np.empty(n, np.int64)
                lib.yt_batch_query_stats(ctx, _p64(ql), _p64(sd),
                                         _p64(al), _p64(us))
                id_offs = np.ctypeslib.as_array(pr.id_offs,
                                                shape=(pr.n + 1,))
                blob = np.ctypeslib.as_array(
                    pr.ids, shape=(max(int(id_offs[pr.n]), 1),)).tobytes()
                rows = []
                for i in range(n):
                    a, b = int(id_offs[lo + i]), int(id_offs[lo + i + 1])
                    rows.append(b"%s\t%d\t%d\t%d\t%d\n" % (
                        blob[a:b], ql[i], sd[i], al[i], us[i]))
                return (text, int(sm.value), int(nr.value),
                        b"".join(rows))
            return text, int(sm.value), int(nr.value)
        finally:
            lib.yt_batch_free(ctx)
