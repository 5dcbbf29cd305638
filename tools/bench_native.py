#!/usr/bin/env python3
"""Interleaved best-of-N wall-clock compare: reference binary vs the
native engine, on identical inputs.  The shared VM's wall clock swings
1.5-2x between runs (BASELINE.md), so runs are interleaved and the
MINIMUM is reported for each side.

Usage: python3 tools/bench_native.py <reads> <index> [--iters 5]
       [--threads 1] [--engine native] [--ref /root/yaha_ref_build/bin/yaha]
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("reads")
    ap.add_argument("index")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--engine", default="native")
    ap.add_argument("--ref", default="/root/yaha_ref_build/bin/yaha")
    args = ap.parse_args()

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    best_ref = best_us = None
    have_ref = os.path.exists(args.ref)
    for _ in range(args.iters):
        if have_ref:
            t0 = time.perf_counter()
            subprocess.run([args.ref, "-x", args.index, "-q", args.reads,
                            "-t", str(args.threads), "-osh",
                            "/tmp/bn_ref.sam"],
                           check=True, capture_output=True)
            dt = time.perf_counter() - t0
            best_ref = dt if best_ref is None else min(best_ref, dt)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "yaha_tpu.cli",
                        "-x", args.index, "-q", args.reads,
                        "-t", str(args.threads), "--engine", args.engine,
                        "-osh", "/tmp/bn_us.sam"],
                       check=True, capture_output=True, env=env)
        dt = time.perf_counter() - t0
        best_us = dt if best_us is None else min(best_us, dt)

    with open(args.reads, "rb") as f:
        n = f.read().count(b">")
    parity = None
    if have_ref:
        def recs(p):
            with open(p, "rb") as f:
                return sorted(l for l in f.read().splitlines()
                              if not l.startswith(b"@PG"))
        parity = recs("/tmp/bn_ref.sam") == recs("/tmp/bn_us.sam")
    out = {"reads": n, "threads": args.threads, "iters": args.iters,
           "engine": args.engine,
           "us_best_s": round(best_us, 3),
           "us_reads_per_s": round(n / best_us, 1)}
    if have_ref:
        out.update({"ref_best_s": round(best_ref, 3),
                    "ref_reads_per_s": round(n / best_ref, 1),
                    "ratio": round(best_ref / best_us, 3),
                    "parity": parity})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
