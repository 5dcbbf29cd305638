#!/usr/bin/env python3
"""Measure the --prewarm payoff (VERDICT r4 #5): fresh-process first-run
wall on a staged workload with and without a prior --prewarm.

Three arms, each a fresh CLI process on the same reads:

  cold           fresh compile cache, no prewarm -> the first-run cliff
                 (every kernel tier compiles);
  prewarm        fresh cache, `--prewarm` only -> pays the same compiles
                 offline (its wall IS the moved cliff);
  after_prewarm  same cache as `prewarm` -> what a production first run
                 costs once prewarmed.

after_prewarm still pays per-process backend attach + cached-executable
loads; the COMPILE cliff is the cold-vs-after delta, which is what
--prewarm removes.  Outputs are parity-diffed across arms.

Usage: python tools/prewarm_bench.py [--reads N] [--len L] [--err E]
Prints one JSON line.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def run_cli(cwd, cache, args, timeout=2400):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_COMPILATION_CACHE_DIR"] = cache
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0.0"
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "yaha_tpu.cli"] + args,
                       cwd=cwd, env=env, capture_output=True,
                       timeout=timeout)
    wall = time.time() - t0
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--len", dest="rlen", type=int, default=1000)
    ap.add_argument("--err", type=float, default=0.05)
    args = ap.parse_args()

    import gzip
    import random
    import make_testdata as mt
    d = tempfile.mkdtemp(prefix="prewarm_")
    try:
        shutil.copy(os.path.join(REPO, "tests/golden/testgen.nib2"), d)
        with gzip.open(os.path.join(
                REPO, "tests/golden/testgen.X11_01_65525S.gz")) as f:
            with open(os.path.join(d, "testgen.X11_01_65525S"),
                      "wb") as o:
                o.write(f.read())
        rng = random.Random(20260816)
        genome_d = mt.make_genome(rng)
        rng = random.Random(77)
        recs = []
        for i in range(args.reads):
            chrom, pos, s = mt.sample_read(rng, genome_d, args.rlen)
            s = mt.mutate(rng, s, args.err, args.err / 4)
            if rng.random() < 0.5:
                s = mt.revcomp(s)
            recs.append(("rd%d" % i, s))
        mt.write_fasta(os.path.join(d, "reads.fasta"), recs)

        base = ["-x", "testgen.X11_01_65525S", "-q", "reads.fasta",
                "--engine", "batch-pallas"]
        c1 = os.path.join(d, "cache_cold")
        c2 = os.path.join(d, "cache_prewarm")
        os.makedirs(c1)
        os.makedirs(c2)

        cold = run_cli(d, c1, base + ["-osh", "cold.sam"])
        prewarm = run_cli(d, c2, base + ["--prewarm", "-osh", "pw.sam"])
        after = run_cli(d, c2, base + ["-osh", "after.sam"])
        # Control: a second fresh process on the cold arm's (now warm)
        # cache — should match `after` (both are loads-only).
        warm_ctrl = run_cli(d, c1, base + ["-osh", "ctrl.sam"])

        def recs(name):
            # @PG embeds the output file name; compare modulo it.
            with open(os.path.join(d, name), "rb") as f:
                return [l for l in f.read().splitlines()
                        if not l.startswith(b"@PG")]
        t_cold = recs("cold.sam")
        t_after = recs("after.sam")
        t_ctrl = recs("ctrl.sam")
        assert not os.path.exists(os.path.join(d, "pw.sam"))

        print(json.dumps({
            "protocol": "fresh CLI process per arm, %d x %d bp, "
                        "testgen L11 index, batch-pallas"
                        % (args.reads, args.rlen),
            "cold_first_run_s": round(cold, 1),
            "prewarm_s": round(prewarm, 1),
            "first_run_after_prewarm_s": round(after, 1),
            "warm_cache_control_s": round(warm_ctrl, 1),
            "compile_cliff_removed_s": round(cold - after, 1),
            "parity": t_cold == t_after == t_ctrl,
            "note": "first_run_after_prewarm still pays per-process "
                    "backend attach + cached-executable loads; the "
                    "compile cliff is cold minus after.",
        }))
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
