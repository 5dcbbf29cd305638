"""Device-mesh scale-out: data-parallel reads x model-parallel index.

The reference scales with pthreads over a shared mmap'd index
(Query.c:34-38,642-691) and has no distributed story (SURVEY.md section
2.2).  The device design replaces that with a 2-D mesh:

  * `data` axis — read batches are sharded across chips; each shard runs
    the full seed->extend pipeline on its reads (the primary scaling axis).
  * `model` axis — the k-mer index is hash-range sharded: each model shard
    holds SO rows for [lo, hi) hash values plus its slice of the ROA, so a
    ~16 GB human-genome index (guide section 3) fits across devices.
    Seed lookups cross the interconnect: every data shard's hashes hit
    all model shards
    (replicated compute on masked ranges) and per-shard hit counts are
    combined with psum over `model`.

Collectives are XLA-inserted through shard_map; no hand-rolled NCCL/MPI
analog exists or is needed.
"""
from __future__ import annotations


import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(n_devices: int | None = None, model_parallel: int = 1):
    devices = np.array(jax.devices()[:n_devices] if n_devices
                       else jax.devices())
    n = len(devices)
    assert n % model_parallel == 0
    return Mesh(devices.reshape(n // model_parallel, model_parallel),
                ("data", "model"))


def rebase_so(so, n_model: int):
    """Hash-range rebasing of the global SO array into n_model shards.

    Shard m owns hash range [m*per, (m+1)*per); its SO rows are rebased
    to LOCAL ROA offsets (so_local[m, i] = so[m*per + i] - so[m*per]).
    Global SO offsets are uint32 cumulative match counts (Index.c:186-194)
    and legitimately exceed 2^31 for genomes past ~2.1 Gbp (design
    ceiling < 4 Gbp, guide section 8.3), so the subtraction must be done
    in uint32 (exact: SO is nondecreasing, so so[h] - base never
    underflows within a shard).  Returns (so_local [M, per+1] uint32,
    bases int64 [M], lens int64 [M]); every local offset is < lens[m],
    and lens[m] < 2^31 is asserted because the device lookup gathers the
    local ROA with int32 indices (parallel/mesh.py kernel,
    ops/seeds_jax.py expand_sort_hits_device).
    """
    so = np.asarray(so, np.uint32)
    ht = len(so) - 1
    assert ht % n_model == 0, (ht, n_model)
    per = ht // n_model
    bounds = so[::per].astype(np.int64)        # [M+1] global shard bases
    bases = bounds[:-1]
    lens = bounds[1:] - bounds[:-1]
    assert (lens < (1 << 31)).all(), (
        "a model shard's ROA slice has %d entries >= 2^31; raise "
        "--model-shards so int32 device gathers stay in range"
        % int(lens.max()))
    # Vectorized rebase: view the first ht entries as [M, per], subtract
    # the per-shard base, and append each shard's end offset.
    body = so[:ht].reshape(n_model, per) - bases.astype(np.uint32)[:, None]
    so_local = np.concatenate(
        [body, (bounds[1:] - bases).astype(np.uint32)[:, None]], axis=1)
    return so_local, bases, lens


class ShardedIndex:
    """Hash-range sharded SO + ROA resident across the `model` axis.

    The TP-analog (SURVEY.md section 2.2): a human-genome index (~4.3 GB
    SO + ~12 GB ROA at L15) is a large share of one device's memory, so
    shard m of M owns
    hash range [m*per, (m+1)*per) -- its SO rows rebased to LOCAL ROA
    offsets -- plus exactly the ROA slice those rows address.  Every seed
    lookup resolves on the owning shard and candidates are merged across
    `model` with an all_gather (the all-to-all candidate exchange of the
    survey's index-placement design).  A side effect of sharding: local
    ROA offsets stay < 2^31 even for a ~3 Gbp genome (asserted in
    rebase_so), so int32 device gathers are safe where a replicated
    index would overflow.
    """

    def __init__(self, index, n_model: int):
        so = np.asarray(index.starting_offs, np.uint32)
        # Keep the caller's roa object un-materialized (it may be an
        # mmap/memmap of a multi-GB on-disk index); only per-shard
        # slices are copied, into roa_sh.
        roa = index.roa
        so_local, bases, lens = rebase_so(so, n_model)
        per = so_local.shape[1] - 1
        rmax = max(int(lens.max()), 1)
        roa_sh = np.zeros((n_model, rmax), np.uint32)
        for m in range(n_model):
            roa_sh[m, :int(lens[m])] = \
                roa[int(bases[m]):int(bases[m] + lens[m])]
        self.n_model = n_model
        self.per = per
        self.word_len = index.word_len
        self.max_hits = index.max_hits
        self.so_local = so_local          # [M, per+1] local offsets
        self.roa_sh = roa_sh              # [M, rmax]
        self.roa_lens = lens
        self.so_nbytes = int(so_local.nbytes)
        self.roa_nbytes = int(roa_sh.nbytes)
        self.hash_lo = (np.arange(n_model, dtype=np.int32) *
                        np.int32(per))

    def place(self, mesh: Mesh, free_host: bool = False):
        """Upload shards with one row per `model` index (replicated over
        `data`).  free_host=True drops the host-side shard copies after
        the upload (an L15 index is 4.3 GB SO + multi-GB ROA; keeping
        both host and device copies doubles peak RSS)."""
        from jax.sharding import NamedSharding
        sh = NamedSharding(mesh, P("model", None))
        sh1 = NamedSharding(mesh, P("model"))
        # device_put of the host arrays sends each device only its own
        # shard (a jnp.asarray first would stage the whole index on one
        # device).
        self.so_dev = jax.device_put(self.so_local, sh)
        self.roa_dev = jax.device_put(self.roa_sh, sh)
        self.lo_dev = jax.device_put(self.hash_lo, sh1)
        if free_host:
            self.so_local = None
            self.roa_sh = None
        return self


def sharded_expand_sort(mesh: Mesh, hashes, clean, sidx: ShardedIndex, *,
                        max_hits: int, capacity: int):
    """Sharded-index seed lookup + cross-shard candidate merge.

    hashes/clean: [B, N] (B sharded over `data`, replicated over `model`).
    Each (data, model) device expands the hits whose hash falls in its
    model shard's range into a [b, C] buffer, all_gathers the per-shard
    buffers over `model`, and sorts the merged (diag, qo) list --
    the device twin of ops/seeds_jax.expand_sort_hits_device with the
    index distributed.  Returns the same dict, replicated over `model`.
    """
    fn = _sharded_expand_sort_jit(mesh, sidx.per, max_hits, capacity)
    diag, qo, total, overflow, wrapped = fn(
        hashes, clean, sidx.so_dev, sidx.lo_dev, sidx.roa_dev)
    return {"diag": diag, "qo": qo, "total": total, "overflow": overflow,
            "wrapped": wrapped,
            "allwrapped": jnp.any(wrapped, axis=1)}


@functools.lru_cache(maxsize=64)
def _sharded_expand_sort_jit(mesh: Mesh, per: int, max_hits: int,
                             capacity: int):
    """jit-compiled shard_map for one (mesh, shard size, capacity tier);
    cached so repeated seed launches skip retracing (jit then caches per
    input shape)."""

    def kernel(h, cl, so, lo, roa):
        so = so[0]
        roa = roa[0]
        lo = lo[0]
        b, n = h.shape
        local = h - lo
        in_rng = (local >= 0) & (local < per)
        idx_h = jnp.clip(local, 0, per - 1)
        so_lo = so[idx_h]
        cnt_u = so[idx_h + 1] - so_lo
        counts = cnt_u.astype(jnp.int32)
        kept_mask = cl & in_rng & (counts > 0) & (counts <= max_hits)
        kept = jnp.where(kept_mask, counts, 0)
        cum = jnp.cumsum(kept, axis=1)
        total = cum[:, -1]
        overflow = total > capacity

        t = jnp.broadcast_to(
            jnp.arange(capacity, dtype=jnp.int32)[None, :], (b, capacity))
        win = jax.vmap(
            lambda c, tt: jnp.searchsorted(c, tt, side="right"))(cum, t)
        win_c = jnp.minimum(win, n - 1)
        base = jnp.where(
            win_c > 0,
            jnp.take_along_axis(cum, jnp.maximum(win_c - 1, 0), axis=1), 0)
        rank = (t - base).astype(jnp.uint32)
        off = jnp.take_along_axis(jnp.where(kept_mask, so_lo, 0), win_c,
                                  axis=1)
        valid = t < total[:, None]
        idx = jnp.where(valid, (off + rank).astype(jnp.int32), 0)
        ro = roa[idx]
        qo = win_c.astype(jnp.int32)
        diag = ro - qo.astype(jnp.uint32)

        # any(ok) per window as a prefix-sum difference over the run's
        # slot range (segment_max produced wrong flags on TPU at large
        # batch shapes; see ops/seeds_jax.py).
        ok = jnp.where(valid & (ro >= qo.astype(jnp.uint32)), 1, 0)
        okc = jnp.concatenate(
            [jnp.zeros((b, 1), ok.dtype), jnp.cumsum(ok, axis=1)],
            axis=1)
        w_end = jnp.minimum(cum, capacity)
        w_start = jnp.minimum(cum - kept, capacity)
        any_ok = (jnp.take_along_axis(okc, w_end, axis=1) -
                  jnp.take_along_axis(okc, w_start, axis=1))
        wrapped = (kept_mask & (any_ok == 0)).astype(jnp.int32)

        diag_m = jnp.where(valid, diag, jnp.uint32(0xFFFFFFFF))
        qo_m = jnp.where(valid, qo, jnp.int32(0x7FFFFFFF))
        # Cross-shard candidate exchange: [M, b, C] -> [b, M*C].
        diag_all = jax.lax.all_gather(diag_m, "model")
        qo_all = jax.lax.all_gather(qo_m, "model")
        m = diag_all.shape[0]
        diag_all = jnp.moveaxis(diag_all, 0, 1).reshape(b, m * capacity)
        qo_all = jnp.moveaxis(qo_all, 0, 1).reshape(b, m * capacity)
        diag_s, qo_s = jax.lax.sort((diag_all, qo_all), num_keys=2,
                                    dimension=1)
        total = jax.lax.psum(total, "model")
        overflow = jax.lax.psum(overflow.astype(jnp.int32), "model") > 0
        # Each window is owned by exactly one shard; psum merges the
        # per-shard wrapped-run flags (the phantom-hit quirk windows,
        # QueryMatch.c:57-69, handled host-side by the caller).
        wrapped = jax.lax.psum(wrapped, "model") > 0
        return diag_s, qo_s, total, overflow, wrapped

    return jax.jit(shard_map(
        kernel, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P("model", None),
                  P("model"), P("model", None)),
        out_specs=(P("data", None), P("data", None), P("data"),
                   P("data"), P("data", None)),
        check_vma=False,
    ))
