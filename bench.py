#!/usr/bin/env python3
"""Device measurements of the staged engine on one NVIDIA GPU.

Runs in ONE process, on the GPU or not at all (no CPU fallback), and
prints the card's name and power limit beside its numbers.  Two parts:

  * kernel rows — each Pallas DP kernel against the XLA program its
    plain twin compiles to (ops/sw_batch.py), on the same device-resident
    inputs, at the main path's shapes: extension w = 21 at ql tiers
    128..16384, gap fill at wband tiers 32..512.  Median wall of timed
    calls ending in block_until_ready, after a compile call.
  * staged rows — StagedAligner end to end (native host phases + device
    DP) with backend "pallas" and backend "xla" on the same parsed reads
    in the same process, warm (first call compiles), each checked
    byte-for-byte against the per-read native pipeline.

Usage:
  python3 bench.py [--genome G.nib2 --index G.X15_01_65525S
      --reads R.fasta ...] [--backends pallas,xla] [--no-kernels]
      [--out FILE]
Without --reads only the kernel rows run.
Prints one JSON line (also written to --out).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

EXT_TIERS = ((128, 16384), (1024, 16384), (4096, 4096), (16384, 1024))
GAP_TIERS = ((32, 128, 16384), (128, 512, 4096), (512, 1024, 1024))


class CompileLog:
    """Counts XLA compilations and their seconds (jax_log_compiles
    records), so set-up compiles are reported apart from run time."""

    def __init__(self):
        import logging
        import jax
        jax.config.update("jax_log_compiles", True)
        self.n, self.seconds = 0, 0.0
        log = self

        class Handler(logging.Handler):
            def emit(self, rec):
                msg = rec.getMessage()
                if msg.startswith("Finished XLA compilation of"):
                    log.n += 1
                    log.seconds += float(msg.rsplit(" in ", 1)[1].split()[0])

        logging.getLogger("jax").addHandler(Handler())

    def take(self):
        out = (self.n, self.seconds)
        self.n, self.seconds = 0, 0.0
        return out


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def _timed(fn, *args, reps=5):
    import jax
    t0 = time.time()
    jax.block_until_ready(fn(*args))
    compile_s = time.time() - t0
    ts = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ts.append(time.time() - t0)
    return float(np.median(ts)), compile_s


def _ext_inputs(rng, ql, n, bw2):
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 4, (n, ql + 2 * bw2)).astype(np.uint8)
    # Half true extensions (5% substitutions), half junk that X-drops.
    keep = rng.random(n) < 0.5
    mut = np.where(rng.random((n, ql)) < 0.05,
                   rng.integers(0, 4, (n, ql)), q).astype(np.uint8)
    r[keep, :ql] = mut[keep]
    qlens = np.full(n, ql, np.int32)
    rlens = np.full(n, ql + bw2, np.int32)
    return q, qlens, r, rlens


def kernel_rows(aa):
    import jax
    import jax.numpy as jnp
    from yaha_tpu.ops import sw_batch, sw_pallas
    base = dict(go=aa.go_cost, ge=aa.ge_cost, rc=aa.r_cost, ms=aa.m_score,
                max_gap=aa.max_gap, max_intron=aa.max_intron)
    ext_kw = dict(band_width=aa.band_width, x_cutoff=aa.x_cutoff, **base)
    bw2 = 2 * aa.band_width
    rng = np.random.default_rng(7)
    rows = []
    for ql, n in EXT_TIERS:
        args = [jnp.asarray(a) for a in _ext_inputs(rng, ql, n, bw2)]
        pallas = jax.jit(lambda *a: sw_pallas.extension_forward_pallas(
            *a, **ext_kw))
        xla = jax.jit(lambda *a: sw_batch.batched_extension_forward(
            *a, **ext_kw))
        tp, cp = _timed(pallas, *args)
        tx, cx = _timed(xla, *args, reps=2)
        same = bool(np.array_equal(np.asarray(pallas(*args)["score"]),
                                   np.asarray(xla(*args)["score"])))
        rows.append({"kernel": "extension", "w": 2 * bw2 + 1, "ql": ql,
                     "n": n, "pallas_s": tp, "xla_s": tx,
                     "pallas_compile_s": cp, "xla_compile_s": cx,
                     "speedup": tx / tp, "scores_equal": same})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    for wband, ql, n in GAP_TIERS:
        q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
        r = q.copy()
        m = rng.random(r.shape) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        half = (wband - 1) // 2
        lens = np.full(n, ql, np.int32)
        bw = np.full(n, half, np.int32)
        args = [jnp.asarray(a) for a in (q, lens, r, lens, bw, bw)]
        pallas = jax.jit(lambda *a: sw_pallas.anchored_forward_pallas_banded(
            *a, wband=wband, **base))
        xla = jax.jit(lambda *a: sw_batch.batched_anchored_forward(
            *a, **base))
        tp, cp = _timed(pallas, *args)
        tx, cx = _timed(xla, *args, reps=2)
        same = bool(np.array_equal(np.asarray(pallas(*args)["score"]),
                                   np.asarray(xla(*args)["score"])))
        rows.append({"kernel": "gap", "wband": wband, "ql": ql, "n": n,
                     "pallas_s": tp, "xla_s": tx,
                     "pallas_compile_s": cp, "xla_compile_s": cx,
                     "speedup": tx / tp, "scores_equal": same})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def staged_rows(aa, genome_path, index_path, reads_paths, threads,
                backends, compiles):
    from yaha_tpu.io import native_loader
    from yaha_tpu.native import host
    from yaha_tpu.models.staged import StagedAligner
    genome = native_loader.load_genome(genome_path)
    index = native_loader.load_index(index_path)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    rows = []
    for path in reads_paths:
        with open(path, "rb") as f:
            data = f.read()
        aa.fastq = data[:1] == b"@"
        pr = host.parse_queries_native(data, aa.fastq, aa.max_query_length,
                                       aa.word_len)
        t0 = time.time()
        ref, _, _, _ = host.align_batch_native(pr, 0, pr.n, genome, index,
                                               aa, n_threads=threads)
        native_s = time.time() - t0
        row = {"reads": os.path.basename(path), "n": pr.n,
               "native_s": native_s}
        for backend in backends:
            st = StagedAligner(aa, genome, index, backend=backend,
                               n_threads=threads)
            compiles.take()
            t0 = time.time()
            text, _, _ = st.align_chunk(pr, 0, pr.n)
            warm = time.time() - t0
            n_first, s_first = compiles.take()
            st.stats = {k: 0 for k in st.stats}
            st.buckets = []
            t0 = time.time()
            text2, _, _ = st.align_chunk(pr, 0, pr.n)
            wall = time.time() - t0
            n_warm, _ = compiles.take()
            s = st.stats
            row[backend] = {
                "first_call_s": warm, "first_call_compiles": n_first,
                "first_call_compile_s": s_first,
                "warm_compiles": n_warm, "wall_s": wall,
                "reads_per_s": pr.n / wall,
                "parity": text == ref and text2 == ref,
                "device_s": s["device_s"], "dp_kernel_s": s["dp_kernel_s"],
                "dp_decode_s": s["dp_decode_s"],
                "host_s": {k[:-2]: s[k] for k in (
                    "begin_s", "gap_host_s", "phase2_s", "ext_host_s",
                    "finish_s")},
                "gap_problems": s["gap_problems"],
                "ext_problems": s["ext_problems"],
                "gap_tiers": {k: v for k, v in s.items()
                              if k.startswith("gap_w")},
                "gap_fallback": s["gap_fallback"],
                "dp_launches": s["dp_launches"],
                "buckets": [list(b) for b in st.buckets]}
        if "pallas" in row and "xla" in row:
            row["pallas_vs_xla"] = (row["xla"]["wall_s"]
                                    / row["pallas"]["wall_s"])
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome")
    ap.add_argument("--index")
    ap.add_argument("--reads", nargs="*", default=[])
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--backends", default="pallas,xla")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        print("bench.py needs a GPU; JAX's default backend is %r."
              % jax.default_backend(), file=sys.stderr)
        return 1
    from yaha_tpu import cli
    from yaha_tpu.config import AlignmentArgs
    cli.setup_compile_cache()
    aa = AlignmentArgs().post_process(True)
    d = jax.devices()[0]
    result = {"card": card(), "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}
    compiles = CompileLog()
    if not args.no_kernels:
        result["kernels"] = kernel_rows(aa)
    if args.reads:
        result["staged"] = staged_rows(aa, args.genome, args.index,
                                       args.reads, args.threads,
                                       args.backends.split(","), compiles)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
