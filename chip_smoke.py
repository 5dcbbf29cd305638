#!/usr/bin/env python3
"""Smoke run of the staged aligner's main path on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and the final ok line is
printed only after every phase passed:

  1. Card and build.  Prints the card's name and power limit
     (nvidia-smi) and rebuilds the native host library from the tracked
     sources (tools/build_native.sh): a .so copied in from elsewhere may
     be built with -march=native for another CPU.
  2. Kernel parity at real widths.  Both Pallas kernels, compiled for the
     card (never interpret mode), against the native host DP:
     score/maxi/maxj equal and decoded edit ops equal on a sample.  The
     DP is integer throughout, so the tolerance is zero.  Prints each
     kernel's compile seconds and memory_analysis().
  3. The main path through the CLI.  A seeded synthetic genome
     (tools/make_big_genome.py), the default L15 index built with -g
     (4.3 GB of starting offsets plus the ROA), and four read sets:
     100 bp / 2%, 1 kb / 5% and 10 kb / 5% sampled from the genome
     (tools/sample_reads.py), plus an SV split-read set
     (tools/make_sv_testdata.py).  Each set is aligned with --engine
     batch-pallas, with --engine batch-pallas --seed device (index
     resident on the card) and with --engine native; the SAM bytes must
     be identical, ignoring @PG lines (they embed the command line).
  4. The card-only tests: pytest -m gpu.

Cut to size: the genome is 0.25 Gbp by default, not the 3 Gbp design
point (--gbp 3.0), because the index build and its upload scale with the
genome and the whole run must finish inside 1200 s; each read set is a
few thousand reads.

One process per card: the card-only tests run first, as a child, while
this process has not touched the card; from then on this process is the
only one using it.  The kernel checks and every alignment run happen in
it (the CLI's main() is called in-process), so each kernel tier compiles
once for the whole smoke.  Steps that need no card (native build, genome,
index and read generation) run as children.

Usage:
  python3 chip_smoke.py                # all phases, one GPU
  python3 chip_smoke.py --gbp 3.0      # the 3 Gbp design-point genome
  python3 chip_smoke.py --four-cards   # only the --seed device
                                       # --model-shards 2 path on a 2x2
                                       # mesh of 4 GPUs, vs --engine native
"""
import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")

READ_SETS = (("100bp", 100, 0.02, 4000),
             ("1kb", 1000, 0.05, 3000),
             ("10kb", 10000, 0.05, 1000))

# Kernel parity shapes at the main path's real widths: extension
# (ql tier, problems) with w = 21; gap fill (wband tier, ql, problems).
EXT_SHAPES = ((128, 16384), (1024, 4096), (16384, 64))
GAP_SHAPES = ((32, 256, 4096), (128, 512, 2048), (512, 1024, 512))

DEVICE_FACTS = (
    "import json, jax; d = jax.devices(); print(json.dumps({"
    "'platform': d[0].platform, 'kind': d[0].device_kind, "
    "'count': len(d)}))")


class SmokeError(Exception):
    pass


def _env():
    env = dict(os.environ)
    # Persist every compiled program, so later children start warm.
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def run(cmd, what, cwd=REPO, timeout=900, quiet=False):
    """Run a child to completion; raise SmokeError on failure."""
    t0 = time.time()
    r = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True,
                       text=True, timeout=timeout)
    dt = time.time() - t0
    if r.returncode != 0:
        raise SmokeError("%s failed (rc %d, %.1f s):\n%s\n%s" % (
            what, r.returncode, dt, r.stdout[-3000:], r.stderr[-6000:]))
    if not quiet:
        print("[%s] ok in %.1f s" % (what, dt), flush=True)
    return r, dt


def device_facts(want_count):
    r, _ = run([sys.executable, "-c", DEVICE_FACTS], "device check",
               quiet=True)
    facts = json.loads(r.stdout.strip().splitlines()[-1])
    if facts["platform"] != "gpu":
        raise SmokeError("JAX found no GPU (platform %r)"
                         % facts["platform"])
    if facts["count"] < want_count:
        raise SmokeError("need %d GPUs, JAX sees %d"
                         % (want_count, facts["count"]))
    return facts


def card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise SmokeError("nvidia-smi failed: %s" % smi.stderr)
    for line in smi.stdout.strip().splitlines():
        print("card: %s" % line.strip(), flush=True)
    so = os.path.join(REPO, "yaha_tpu", "native", "libyaha_host.so")
    if os.path.exists(so):
        os.unlink(so)
    run(["bash", os.path.join(REPO, "tools", "build_native.sh")],
        "native build")


# ---- phase 2: kernels vs the native DP (runs in a child) ----

def _kernel_parity():
    import numpy as np
    import jax
    from yaha_tpu.config import AlignmentArgs
    from yaha_tpu.native import host
    from yaha_tpu.ops import dp_common, sw_pallas

    aa = AlignmentArgs().post_process(True)
    base = dict(go=aa.go_cost, ge=aa.ge_cost, rc=aa.r_cost, ms=aa.m_score,
                max_gap=aa.max_gap, max_intron=aa.max_intron)
    rng = np.random.default_rng(20261016)

    def mutated(n, ql, rl, junk):
        """Reference rows: mutated copies of the query (5% subs plus a
        short indel) or, for a `junk` share, unrelated sequence."""
        q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
        r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
        for k in range(n):
            if rng.random() < junk:
                continue
            src = q[k].copy()
            m = rng.random(ql) < 0.05
            src[m] = rng.integers(0, 4, int(m.sum()))
            p, d = int(rng.integers(1, ql)), int(rng.integers(1, 4))
            src = (np.concatenate([src[:p], src[p + d:]]) if rng.random()
                   < 0.5 else np.concatenate(
                       [src[:p], rng.integers(0, 4, d).astype(np.uint8),
                        src[p:]]))
            m = min(len(src), rl)
            r[k, :m] = src[:m]
        return q, r

    def compiled(fn, *args, **kw):
        t0 = time.time()
        c = fn.lower(*args, **kw).compile()
        dt = time.time() - t0
        return c, dt

    bw2 = 2 * aa.band_width
    ext_kw = dict(band_width=aa.band_width, x_cutoff=aa.x_cutoff, **base)
    for ql, n in EXT_SHAPES:
        q, r = mutated(n, ql, ql + 2 * bw2, junk=0.5)
        qlens = rng.integers(ql // 2, ql + 1, n).astype(np.int32)
        rlens = np.minimum(qlens + bw2, ql + 2 * bw2).astype(np.int32)
        r = np.where(np.arange(ql + 2 * bw2)[None, :] < rlens[:, None], r,
                     np.uint8(255))
        c, dt = compiled(sw_pallas.extension_forward_pallas, q, qlens, r,
                         rlens, **ext_kw)
        t0 = time.time()
        out = jax.block_until_ready(c(q, qlens, r, rlens))
        run_s = time.time() - t0
        ref = host.extension_forward(q, qlens.astype(np.int64), r,
                                     rlens.astype(np.int64), **ext_kw)
        for key in ("score", "maxi", "maxj"):
            if not np.array_equal(np.asarray(out[key]), ref[key]):
                bad = np.nonzero(np.asarray(out[key]) != ref[key])[0]
                raise SmokeError("extension ql=%d: %s differs at %d "
                                 "problems, first %d" % (ql, key, len(bad),
                                                         bad[0]))
        ks = rng.choice(n, min(n, 256), replace=False)
        bt = np.asarray(sw_pallas.problem_major(out["bt"][:, :, ks]))
        for i, k in enumerate(ks):
            want = dp_common.traceback_extension(
                ref["eo"][k], ref["idc"][k], int(ref["maxi"][k]),
                int(ref["maxj"][k]), int(ref["score"][k]), bw2, False)
            got = dp_common.traceback_extension_packed(
                bt[i], int(ref["maxi"][k]), int(ref["maxj"][k]),
                int(ref["score"][k]), bw2, False)
            if got != want:
                raise SmokeError("extension ql=%d: edit ops differ at "
                                 "problem %d" % (ql, k))
        print("kernel extension w=%d ql=%d n=%d: parity ok; compile "
              "%.2f s, first run %.3f s; memory %s" % (
                  2 * bw2 + 1, ql, n, dt, run_s, c.memory_analysis()),
              flush=True)

    for wband, ql, n in GAP_SHAPES:
        half = (wband - 1) // 2
        qlens = rng.integers(ql // 2, ql + 1, n).astype(np.int64)
        diff = rng.integers(-min(half, 8), min(half, 8) + 1, n)
        rlens = np.clip(qlens + diff, 1, ql + 8).astype(np.int64)
        q, r = mutated(n, ql, ql + 8, junk=0.1)
        lbw = np.maximum(half // 2, qlens - rlens + 1)
        rbw = np.maximum(half // 2, rlens - qlens + 1)
        over = lbw + rbw + 1 - wband
        rbw = np.where(over > 0, rbw - over, rbw)
        c, dt = compiled(sw_pallas.anchored_forward_pallas_banded, q, qlens,
                         r, rlens, lbw, rbw, wband=wband, **base)
        t0 = time.time()
        out = jax.block_until_ready(c(q, qlens, r, rlens, lbw, rbw))
        run_s = time.time() - t0
        ref = host.anchored_forward(q, qlens, r, rlens, lbw, rbw, **base)
        if not np.array_equal(np.asarray(out["score"]), ref["score"]):
            bad = np.nonzero(np.asarray(out["score"]) != ref["score"])[0]
            raise SmokeError("gap wband=%d: score differs at %d problems, "
                             "first %d" % (wband, len(bad), bad[0]))
        ks = rng.choice(n, min(n, 128), replace=False)
        bt = np.asarray(sw_pallas.problem_major(out["bt_b"][:, :, ks]))
        for i, k in enumerate(ks):
            want = dp_common.traceback_anchored(
                ref["eo"][k], ref["idc"][k], int(qlens[k]), int(rlens[k]))
            got = dp_common.traceback_anchored_banded_packed(
                bt[i], int(lbw[k]), int(qlens[k]), int(rlens[k]))
            if got != want:
                raise SmokeError("gap wband=%d: edit ops differ at "
                                 "problem %d" % (wband, k))
        print("kernel gap wband=%d ql=%d n=%d: parity ok; compile %.2f s, "
              "first run %.3f s; memory %s" % (
                  wband, ql, n, dt, run_s, c.memory_analysis()), flush=True)


# ---- phase 3: the main path through the CLI ----

def _strip_pg(path):
    with open(path, "rb") as f:
        return b"".join(l for l in f.readlines() if not l.startswith(b"@PG"))


def make_inputs(gbp, sets):
    """Genome, index and read sets under WORK (made from fixed seeds);
    returns ({set: (reads path, extra CLI args)}, index file name)."""
    os.makedirs(WORK, exist_ok=True)
    fa = os.path.join(WORK, "genome.fasta")
    tools = os.path.join(REPO, "tools")
    run([sys.executable, os.path.join(tools, "make_big_genome.py"), fa,
         "--gbp", str(gbp), "--seed", "7"], "genome %.2f Gbp" % gbp)
    run([sys.executable, "-m", "yaha_tpu.cli", "-g", fa, "-t", "16"],
        "index build (L15)", timeout=1200)
    nib2 = os.path.join(WORK, "genome.nib2")
    paths = {}
    for name, length, err, n in READ_SETS:
        if name not in sets:
            continue
        p = os.path.join(WORK, "reads_%s.fasta" % name)
        run([sys.executable, os.path.join(tools, "sample_reads.py"), nib2,
             p, "--n", str(n), "--len", str(length), "--err", str(err),
             "--seed", str(length)], "reads %s" % name)
        paths[name] = (p, [])
    if "sv" in sets:
        run([sys.executable, os.path.join(tools, "make_sv_testdata.py"),
             nib2, os.path.join(WORK, "sv"), "--events", "150"],
            "reads sv")
        paths["sv"] = (os.path.join(WORK, "sv.fasta"), ["-FBS", "Y"])
    return paths, os.path.join(WORK, "genome.X15_01_65525S")


def cli_run(argv, what):
    """Run the CLI's main() in this process; returns its stderr."""
    import contextlib
    import io
    from yaha_tpu import cli
    err = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    except SystemExit as e:
        rc = e.code
    dt = time.time() - t0
    gc.collect()    # drop the run's device arrays before the next one
    if rc not in (0, None):
        raise SmokeError("%s failed (rc %r, %.1f s):\n%s"
                         % (what, rc, dt, err.getvalue()[-6000:]))
    print("[%s] ok in %.1f s" % (what, dt), flush=True)
    return err.getvalue()


def align_and_compare(paths, index, configs):
    """Align every read set with every (label, CLI args) config and
    with --engine native; the SAM bytes (minus @PG) must match."""
    for name, (reads, extra) in paths.items():
        outs = {}
        for label, args in configs + [("native", ["--engine", "native"])]:
            out = os.path.join(WORK, "%s.%s.sam" % (name, label))
            err = cli_run(["-x", index, "-q", reads, "-t", "16", "-v",
                           "-osh", out] + args + extra,
                          "align %s %s" % (name, label))
            outs[label] = _strip_pg(out)
            for line in err.splitlines():
                if line.startswith(("Throughput", "Device DP", "Gap dispatch",
                                    "Device peak", "Processed")):
                    print("    %s" % line, flush=True)
        ref = outs["native"]
        n_rec = sum(1 for l in ref.splitlines() if not l.startswith(b"@"))
        for label in outs:
            if outs[label] != ref:
                raise SmokeError("%s: --%s SAM differs from --engine "
                                 "native" % (name, label))
        print("parity %s: %s == native (%d records, integer DP: exact)"
              % (name, ", ".join(l for l, _ in configs), n_rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gbp", type=float, default=0.25)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --seed device --model-shards 2 "
                    "path on a 2x2 mesh of 4 GPUs and its comparison "
                    "with --engine native")
    args = ap.parse_args()

    count = 4 if args.four_cards else 1
    t_start = time.time()
    try:
        device_facts(count)
        card_and_build()
        if not args.four_cards:
            r, _ = run([sys.executable, "-m", "pytest", "-m", "gpu",
                        "tests/", "-q", "-p", "no:cacheprovider"],
                       "pytest -m gpu", timeout=600)
            print("    " + r.stdout.strip().splitlines()[-1], flush=True)
        # From here on this process is the one that uses the card.
        sys.path.insert(0, REPO)
        if args.four_cards:
            paths, index = make_inputs(args.gbp, ("1kb", "sv"))
            align_and_compare(paths, index, [("model-shards-2", [
                "--engine", "batch-pallas", "--seed", "device",
                "--model-shards", "2"])])
        else:
            t0 = time.time()
            _kernel_parity()
            print("[kernel parity] ok in %.1f s" % (time.time() - t0),
                  flush=True)
            paths, index = make_inputs(args.gbp,
                                       ("100bp", "1kb", "10kb", "sv"))
            align_and_compare(paths, index, [
                ("batch-pallas", ["--engine", "batch-pallas"]),
                ("batch-pallas-seed-device", ["--engine", "batch-pallas",
                                              "--seed", "device"])])
        import jax
        d = jax.devices()
        facts = {"platform": d[0].platform, "kind": d[0].device_kind,
                 "count": len(d)}
        if facts["platform"] != "gpu" or facts["count"] < count:
            raise SmokeError("devices changed: %r" % (facts,))
    except (SmokeError, subprocess.TimeoutExpired, OSError) as e:
        print("SMOKE FAILED: %s" % e, file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print("all phases passed in %.1f s" % (time.time() - t_start))
    print(json.dumps({"ok": True, "device": facts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
