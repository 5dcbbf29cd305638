#!/usr/bin/env python3
"""End-to-end reads/s benchmark: yaha_tpu CLI vs the reference binary.

Generates a read set against the checked-in test genome (same synthetic
genome as tests/golden), runs both aligners on the same prebuilt L11
index, checks record parity (ignoring @PG), and prints one JSON line per
configuration.

Usage:
  python tools/e2e_bench.py [--reads 4000] [--len 100] [--threads 1,8]
                            [--engine batch] [--ref /path/to/yaha]
"""
import argparse
import gzip
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, TOOLS)
sys.path.insert(0, REPO)

import make_testdata as mt  # noqa: E402


def _stage(d):
    shutil.copy(os.path.join(REPO, "tests/golden/testgen.nib2"), d)
    with gzip.open(os.path.join(
            REPO, "tests/golden/testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(d, "testgen.X11_01_65525S"), "wb") as out:
            out.write(f.read())


def _gen_reads(d, n, read_len, err):
    rng = random.Random(20260816)
    genome = mt.make_genome(rng)
    rng = random.Random(97531)
    recs = []
    for i in range(n):
        chrom, pos, s = mt.sample_read(rng, genome, read_len)
        s = mt.mutate(rng, s, err, err / 4)
        if rng.random() < 0.5:
            s = mt.revcomp(s)
        recs.append(("rd_%d_%s_%d" % (i, chrom, pos), s))
    path = os.path.join(d, "bench_reads.fasta")
    mt.write_fasta(path, recs)
    return path


def _records(path):
    # Sorted: the reference's -t N output order is thread-completion-
    # dependent (Query.c flockfile), so parity is on the record multiset.
    with open(path, "rb") as f:
        return sorted(l for l in f.read().splitlines(True)
                      if not l.startswith(b"@PG"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=4000)
    ap.add_argument("--len", dest="read_len", type=int, default=100)
    ap.add_argument("--err", type=float, default=0.02)
    ap.add_argument("--threads", default="1,8")
    ap.add_argument("--engine", default="native")
    ap.add_argument("--ref", default="/root/yaha_ref_build/bin/yaha")
    ap.add_argument("--iters", type=int, default=1,
                    help="best-of-N wall clock (the shared VM swings "
                         "1.5-2x between runs)")
    args = ap.parse_args()

    d = tempfile.mkdtemp(prefix="e2e_bench_")
    _stage(d)
    reads = _gen_reads(d, args.reads, args.read_len, args.err)
    threads = [int(t) for t in args.threads.split(",")]
    results = []
    ref_recs = None

    have_ref = os.path.exists(args.ref)
    for t in threads:
        ref_dt = my_dt = None
        out_ref = os.path.join(d, "ref_t%d.sam" % t)
        out_my = os.path.join(d, "mine_t%d.sam" % t)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        for _ in range(args.iters):
            if have_ref:
                t0 = time.perf_counter()
                subprocess.run([args.ref, "-x", "testgen.X11_01_65525S",
                                "-q", os.path.basename(reads), "-t",
                                str(t), "-osh",
                                os.path.basename(out_ref)],
                               cwd=d, check=True, capture_output=True)
                dt = time.perf_counter() - t0
                ref_dt = dt if ref_dt is None else min(ref_dt, dt)
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "yaha_tpu.cli",
                            "-x", "testgen.X11_01_65525S",
                            "-q", os.path.basename(reads), "-t", str(t),
                            "--engine", args.engine,
                            "-osh", os.path.basename(out_my)],
                           cwd=d, check=True, capture_output=True, env=env)
            dt = time.perf_counter() - t0
            my_dt = dt if my_dt is None else min(my_dt, dt)
        if have_ref:
            results.append({"who": "reference", "threads": t,
                            "reads_per_s": round(args.reads / ref_dt, 1),
                            "wall_s": round(ref_dt, 2)})
            if ref_recs is None:
                ref_recs = _records(out_ref)
        mine = _records(out_my)
        parity = (ref_recs == mine) if ref_recs is not None else None
        results.append({"who": "yaha_tpu/" + args.engine, "threads": t,
                        "reads_per_s": round(args.reads / my_dt, 1),
                        "wall_s": round(my_dt, 2), "parity": parity})

    for r in results:
        print(json.dumps(r))
    shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
