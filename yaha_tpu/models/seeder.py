"""Device seed phase for the staged engine (the composed product path).

VERDICT r3 item 1: the staged C++ pipeline (the product engine) and the
scale-out path (ShardedIndex over a (data x model) mesh) were disjoint —
the mesh path ran the per-read-Python BatchAligner back half.  This
module composes them: the seed scan + SO lookup + ragged ROA expansion +
(diag, qo) sort run on the device (sharded over the mesh when one is
given, single-device otherwise), and the resulting per-(read, strand)
hit rows feed the native staged chaining (yt_hits_to_clumps) — zero
per-read Python anywhere.

Reference match: Query.c:361-412 (seed loop) + QueryMatch.c:52-121
(heap merge) — here one batched device program per chunk; the index
placement is SURVEY.md section 2.2's TP-analog (hash-range sharded
SO + ROA, candidates merged with an all_gather over `model`).

Correctness edges (all kept on the device path):
  * phantom-hit quirk (QueryMatch.c:57-69): device flags all-wrapped
    windows; the exact phantom hits are injected host-side per flagged
    row and merged in sorted position (core/frags.phantom_hits);
  * capacity overflow: rows that exceed the first capacity tier retry
    one big tier; rows exceeding the top tier take the native host scan
    for that strand (hit_totals[row] = -1) — the per-query realloc
    analog (Query.c:81-100) as static tiers.

Hit rows leave the device as ONE ragged gather per plane (diag, qo) —
transfers scale with actual hits, not rows x capacity.
"""
from __future__ import annotations

import ctypes

import numpy as np

M32 = 0xFFFFFFFF


def _pow2(x, lo=1):
    return max(lo, 1 << (int(x) - 1).bit_length())


class _IndexView:
    """Duck-types io.index_io.Index (starting_offs / roa / word_len /
    max_hits) over a NativeIndex's mmap'd pointers, zero-copy."""

    def __init__(self, index):
        self.word_len = index.word_len
        self.max_hits = index.max_hits
        if hasattr(index, "starting_offs"):
            self.starting_offs = np.asarray(index.starting_offs,
                                            np.uint32)
            self.roa = np.asarray(index.roa, np.uint32)
        else:
            ht = 1 << (2 * index.word_len)
            self.starting_offs = np.ctypeslib.as_array(
                index.so_ptr, shape=(ht + 1,))
            self.roa = np.ctypeslib.as_array(
                index.roa_ptr, shape=(max(int(index.roa_len), 1),))


class DeviceSeeder:
    """Seed-phase provider for StagedAligner (the `seeder` argument).

    mesh: a jax.sharding.Mesh with ("data", "model") axes — the
    sharded-index scale-out path; None = single-device lookup (the whole
    SO + ROA resident in one device's HBM).
    """

    CAP_TIERS = (1024, 8192)

    def __init__(self, aa, index, mesh=None, n_model=1):
        import jax
        import jax.numpy as jnp
        import threading
        self.aa = aa
        self.word_len = index.word_len
        self.iview = _IndexView(index)
        self.mesh = mesh
        self.sidx = None
        self.stats = {"seed_launches": 0, "seed_h2d_bytes": 0,
                      "seed_d2h_bytes": 0, "all_gather_bytes": 0,
                      "phantom_rows": 0, "fallback_rows": 0,
                      "seed_device_s": 0.0, "cap_retries": 0}
        # seed_chunk may run concurrently under the CLI's depth-2
        # prefetch pipeline (ADVICE r4): guard stat read-modify-writes
        # the same way StagedAligner._acc does.
        self._stats_lock = threading.Lock()
        # Host-side 4-bit code tables (Math.c:141-231) for building the
        # device batch and for phantom recompute.
        from ..utils import codec
        self.code_tab = np.asarray(codec.FOUR_BIT_CODES, np.uint8)
        self.comp_tab = np.asarray(codec.FOUR_BIT_COMP_CODES, np.uint8)
        if mesh is not None:
            from ..parallel.mesh import ShardedIndex
            # free_host: once the shards are device-resident the host
            # copies are dead weight (4.3 GB SO + multi-GB ROA at L15);
            # phantom recompute reads iview's zero-copy mmap views.
            self.sidx = ShardedIndex(self.iview, n_model).place(
                mesh, free_host=True)
            self.data_size = mesh.shape["data"]
        else:
            # Single-device lookup gathers the ROA with int32 indices
            # (ops/seeds_jax.py expand_sort_hits_device); genomes past
            # ~2.1 Gbp need the sharded path, whose per-shard rebasing
            # keeps local offsets < 2^31 (parallel/mesh.rebase_so).
            if len(self.iview.roa) >= (1 << 31):
                raise ValueError(
                    "index ROA has %d entries >= 2^31; single-device "
                    "seed lookup cannot address it — use --model-shards"
                    % len(self.iview.roa))
            self.so_dev = jnp.asarray(self.iview.starting_offs)
            self.roa_dev = jnp.asarray(self.iview.roa)
            self.data_size = 1
        # Lazy (an int64 copy of the L15 SO array is 8.6 GB — only pay
        # it if a phantom row ever occurs) but built under _stats_lock
        # so concurrent seed_chunk calls never race the init (ADVICE r4).
        self._so64 = None

    def _acc(self, **kv):
        with self._stats_lock:
            for k, v in kv.items():
                self.stats[k] += v

    # ---- batch build ----

    def _codes_batch(self, pr, lo, hi):
        """[2*(hi-lo) rows, lpad] uint8 code batch (row 2i = fwd,
        2i+1 = revcomp) + lengths, padded with N codes."""
        n = hi - lo
        offs = np.ctypeslib.as_array(pr.seq_offs, shape=(pr.n + 1,))
        total = int(offs[pr.n])
        seqs = np.ctypeslib.as_array(pr.seqs, shape=(max(total, 1),))
        lens = (offs[lo + 1:hi + 1] - offs[lo:hi]).astype(np.int32)
        lmax = int(lens.max()) if n else 1
        lpad = _pow2(max(lmax, 64))
        rows = 2 * n
        bpad = _pow2(max(rows, 16))
        if self.data_size > 1:
            # shard_map needs the batch dim divisible by the data axis;
            # a pow2 bpad is not a multiple of a non-pow2 axis (e.g. 6
            # devices / --model-shards 2 -> data=3), so round up to a
            # multiple (no-op for pow2 axes; ADVICE r4).
            bpad = max(bpad, _pow2(self.data_size))
            bpad = -(-bpad // self.data_size) * self.data_size
        codes = np.full((bpad, lpad), 4, np.uint8)
        lengths = np.zeros(bpad, np.int32)
        lengths[:rows] = np.repeat(lens, 2)
        total_seg = int(offs[hi]) - int(offs[lo])
        if total_seg:
            # Vectorized scatter (no per-read Python): code every base
            # once, then place row 2i at column j and the revcomp row
            # 2i+1 at column len-1-j via flat indices.
            fwd = self.code_tab[seqs[int(offs[lo]):int(offs[hi])]]
            lens64 = lens.astype(np.int64)
            row_of = np.repeat(np.arange(n, dtype=np.int64), lens64)
            pos_in = (np.arange(total_seg, dtype=np.int64) -
                      np.repeat((offs[lo:hi] - offs[lo]).astype(np.int64),
                                lens64))
            flat = codes.reshape(-1)
            flat[(2 * row_of) * lpad + pos_in] = fwd
            flat[(2 * row_of + 1) * lpad +
                 (lens64[row_of] - 1 - pos_in)] = self.comp_tab[fwd]
        return codes, lengths, rows

    # ---- device lookup ----

    def _expand(self, codes, lengths, capacity):
        import jax
        import jax.numpy as jnp
        from ..ops import seeds_jax
        aa = self.aa
        self._acc(seed_launches=1,
                  seed_h2d_bytes=codes.nbytes + lengths.nbytes)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.mesh import sharded_expand_sort
            codes_d = jax.device_put(
                codes, NamedSharding(self.mesh, P("data", None)))
            lens_d = jax.device_put(
                lengths, NamedSharding(self.mesh, P("data")))
            hashes, clean = seeds_jax.batched_seed_hashes(
                codes_d, lens_d, word_len=self.word_len)
            out = sharded_expand_sort(
                self.mesh, hashes, clean, self.sidx,
                max_hits=int(aa.max_hits), capacity=capacity)
            m = self.mesh.shape["model"]
            self._acc(all_gather_bytes=2 * 4 * m * codes.shape[0]
                      * capacity)
            return out
        hashes, clean = seeds_jax.batched_seed_hashes(
            jnp.asarray(codes), jnp.asarray(lengths),
            word_len=self.word_len)
        return seeds_jax.expand_sort_hits_device(
            hashes, clean, self.so_dev, self.roa_dev,
            max_hits=int(aa.max_hits), capacity=capacity)

    def _ragged_fetch(self, out, rows, capacity):
        """d2h the valid hit prefixes as ONE flat gather per plane.

        Returns (diag_flat uint32, qo_flat int32, offs int64[rows+1],
        totals int64[rows]) — totals clipped at the row width (overflow
        rows are refetched at a bigger tier or routed to the host scan
        by the caller).  On the mesh path rows are [B, M*capacity]
        (all_gather over `model` widens them), so the clip/stride use
        the actual plane width, not the per-shard capacity."""
        import jax.numpy as jnp
        from ..ops import decode_jax
        width = int(out["diag"].shape[1])
        totals = np.asarray(out["total"]).astype(np.int64)[:rows]
        take = np.minimum(totals, width)
        self._acc(seed_d2h_bytes=8 * rows + rows // 8 + 1)
        n = rows
        order = np.argsort(take, kind="stable")
        t_sorted = take[order]
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(t_sorted, out=starts[1:])
        total = int(starts[n])
        total_pad = _pow2(max(total, 1024))
        n_pad = _pow2(max(n, 256))
        src_aug = np.zeros(n_pad + 1, np.int32)
        src_aug[:n] = order
        t_aug = np.zeros(n_pad + 1, np.int64)
        t_aug[:n] = t_sorted
        t_aug[n_pad] = total_pad - total
        starts_aug = np.full(n_pad + 1, total, np.int64)
        starts_aug[:n] = starts[:n]
        flat_d = decode_jax.gather_rle_flat(
            out["diag"].view(jnp.int32), src_aug, t_aug, starts_aug,
            cap=width, total_pad=total_pad)
        flat_q = decode_jax.gather_rle_flat(
            out["qo"], src_aug, t_aug, starts_aug,
            cap=width, total_pad=total_pad)
        diag_s = np.asarray(flat_d)[:total].view(np.uint32)
        qo_s = np.asarray(flat_q)[:total]
        self._acc(seed_d2h_bytes=8 * total)
        # Un-sort to row-major layout with one vectorized gather: element
        # j of row r sits at starts[rank(r)] + j in the sorted layout.
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(take, out=offs[1:])
        if total:
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            row_of = np.repeat(np.arange(n), take)
            src = (starts[inv[row_of]] +
                   (np.arange(total) - offs[row_of]))
            diag = diag_s[src]
            qo = qo_s[src]
        else:
            diag = np.zeros(0, np.uint32)
            qo = np.zeros(0, np.int32)
        return diag, qo, offs, totals

    # ---- phantom injection (QueryMatch.c:57-69) ----

    def _inject_row(self, codes_row, qlen, wrapped_row, diag, qo):
        from ..core.frags import phantom_hits
        wl = self.word_len
        offs_w = np.flatnonzero(wrapped_row)
        with self._stats_lock:
            if self._so64 is None:
                self._so64 = self.iview.starting_offs.astype(np.int64)
        so = self._so64
        c = codes_row[:qlen].astype(np.int64)
        h = np.zeros(len(offs_w), np.int64)
        for t in range(wl):
            h = (h << 2) | c[offs_w + t]
        so_offs = so[h]
        counts = so[h + 1] - so[h]
        extra_qo, extra_ro = phantom_hits(
            offs_w, so_offs, counts, self.iview.roa, range(len(offs_w)))
        if not extra_qo:
            return diag, qo
        qo2 = np.concatenate([qo.astype(np.int64),
                              np.asarray(extra_qo, np.int64)])
        diag2 = np.concatenate(
            [diag.astype(np.int64),
             (np.asarray(extra_ro, np.int64) -
              np.asarray(extra_qo, np.int64)) & M32])
        order = np.lexsort((qo2, diag2))
        return diag2[order].astype(np.uint32), qo2[order].astype(np.int32)

    # ---- entry ----

    def seed_chunk(self, pr, lo, hi, aligner=None):
        """Compute per-(read, strand) sorted hit rows for reads [lo, hi)
        of a ParsedReads.  Returns (diag uint32, qo int32,
        offs int64[2n+1], totals int64[2n]) for yt_batch_begin."""
        import time
        t0 = time.time()
        codes, lengths, rows = self._codes_batch(pr, lo, hi)
        out1 = self._expand(codes, lengths, self.CAP_TIERS[0])
        allw = np.asarray(out1["allwrapped"])[:rows]
        overflow = np.asarray(out1["overflow"])[:rows]
        over_rows = np.flatnonzero(overflow)
        out2 = None
        n2 = len(over_rows)
        if n2:
            # Compacted retry: only the overflowed rows re-expand at the
            # big tier (the per-query realloc analog, Query.c:81-100) —
            # the retry batch is the overflow population, not the chunk.
            self._acc(cap_retries=1)
            bpad2 = _pow2(max(n2, 16))
            if self.data_size > 1:
                bpad2 = max(bpad2, _pow2(self.data_size))
                bpad2 = -(-bpad2 // self.data_size) * self.data_size
            codes2 = np.full((bpad2, codes.shape[1]), 4, np.uint8)
            lengths2 = np.zeros(bpad2, np.int32)
            codes2[:n2] = codes[over_rows]
            lengths2[:n2] = lengths[over_rows]
            out2 = self._expand(codes2, lengths2, self.CAP_TIERS[1])
        d1, q1, offs1, tot1 = self._ragged_fetch(out1, rows,
                                                 self.CAP_TIERS[0])
        if out2 is not None:
            d2, q2, offs2, tot2 = self._ragged_fetch(out2, n2,
                                                     self.CAP_TIERS[1])
            over2 = np.asarray(out2["overflow"])[:n2]
        pos_in2 = np.full(rows, -1, np.int64)
        pos_in2[over_rows] = np.arange(n2)
        # Exceptional rows: tier-2 splices and/or phantom injection.
        # Everything else leaves tier 1 untouched, so the common case
        # (no overflow, no all-wrapped window) is zero-copy.
        exc = np.flatnonzero(overflow | allw)
        if exc.size == 0:
            self._acc(seed_device_s=time.time() - t0)
            return d1, q1, offs1, tot1
        # One device gather per plane for the wrapped flags of just the
        # flagged rows (phantom recompute needs the window bitmap).
        w_rows1 = np.flatnonzero(allw & ~overflow)
        wrap1 = (np.asarray(out1["wrapped"][w_rows1])
                 if len(w_rows1) else None)
        wrap1_pos = np.full(rows, -1, np.int64)
        wrap1_pos[w_rows1] = np.arange(len(w_rows1))
        wrap2 = np.asarray(out2["wrapped"][:n2]) if out2 is not None \
            else None
        totals = tot1.copy()
        parts_d, parts_q = [], []
        prev = 0
        offs = np.zeros(rows + 1, np.int64)
        pos = 0
        for r in exc:
            # bulk span of untouched tier-1 rows [prev, r)
            if offs1[r] > offs1[prev]:
                parts_d.append(d1[offs1[prev]:offs1[r]])
                parts_q.append(q1[offs1[prev]:offs1[r]])
                pos += offs1[r] - offs1[prev]
            offs[prev + 1:r + 1] = offs[prev] + \
                (offs1[prev + 1:r + 1] - offs1[prev])
            if overflow[r]:
                k = pos_in2[r]
                if out2 is None or over2[k]:
                    # top-tier overflow: host scan for this strand
                    totals[r] = -1
                    offs[r + 1] = pos
                    self._acc(fallback_rows=1)
                    prev = r + 1
                    continue
                d = d2[offs2[k]:offs2[k + 1]]
                q = q2[offs2[k]:offs2[k + 1]]
                totals[r] = tot2[k]
                # Tier-1 wrapped flags UNDER-flag windows whose whole
                # expansion fell beyond the capacity cutoff (their
                # segment is empty, and segment_max's empty identity is
                # INT_MIN, not 0) — always use the exact tier-2 flags
                # for rows served by tier 2.
                wrapped_row = wrap2[k]
            else:
                d = d1[offs1[r]:offs1[r + 1]]
                q = q1[offs1[r]:offs1[r + 1]]
                wrapped_row = wrap1[wrap1_pos[r]]
            if wrapped_row is not None and wrapped_row.any():
                # some window's run is all-wrapped: inject phantoms
                self._acc(phantom_rows=1)
                d, q = self._inject_row(codes[r], int(lengths[r]),
                                        wrapped_row, d, q)
            parts_d.append(d)
            parts_q.append(q)
            pos += len(d)
            offs[r + 1] = pos
            prev = r + 1
        if offs1[rows] > offs1[prev]:
            parts_d.append(d1[offs1[prev]:offs1[rows]])
            parts_q.append(q1[offs1[prev]:offs1[rows]])
        offs[prev + 1:rows + 1] = offs[prev] + \
            (offs1[prev + 1:rows + 1] - offs1[prev])
        diag = (np.concatenate(parts_d) if parts_d
                else np.zeros(0, np.uint32))
        qo = (np.concatenate(parts_q) if parts_q
              else np.zeros(0, np.int32))
        diag = np.ascontiguousarray(diag, dtype=np.uint32)
        qo = np.ascontiguousarray(qo, dtype=np.int32)
        self._acc(seed_device_s=time.time() - t0)
        return diag, qo, offs, totals
