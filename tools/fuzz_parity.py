#!/usr/bin/env python3
"""Differential fuzzing vs the reference binary.

Generates random small genomes, read sets (including long reads, extreme
error rates, SV chimeras, IUPAC codes), and random CLI configs; runs both
the reference binary and yaha_tpu; diffs the outputs (ignoring the @PG
line, which embeds file names).  Requires the reference built at
/root/yaha_ref_build/bin/yaha.

Usage: python tools/fuzz_parity.py [n_iters] [seed0]
"""
import os
import random
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAHA = "/root/yaha_ref_build/bin/yaha"

BASES = "ACGT"


def gen_genome(rng, path):
    n_seqs = rng.randint(1, 4)
    genome = {}
    with open(path, "w") as f:
        for s in range(n_seqs):
            name = "c%d" % s
            size = rng.randint(2000, 60000)
            seq = [rng.choice(BASES) for _ in range(size)]
            # repeats
            if size > 3000:
                rep = [rng.choice(BASES) for _ in range(rng.randint(50, 300))]
                for _ in range(rng.randint(0, 12)):
                    p = rng.randrange(0, size - len(rep))
                    seq[p:p + len(rep)] = rep
            # N runs
            for _ in range(rng.randint(0, 3)):
                p = rng.randrange(0, size - 100)
                ln = rng.randint(1, 90)
                seq[p:p + ln] = "N" * ln
            genome[name] = "".join(seq)
            f.write(">%s\n" % name)
            for i in range(0, size, 60):
                f.write(genome[name][i:i + 60] + "\n")
    return genome


COMP = str.maketrans("ACGTN", "TGCAN")


def gen_reads(rng, genome, path, fastq=False):
    names = list(genome)
    n_reads = rng.randint(5, 60)
    iupac = "RYKMSWBDHVN"
    with open(path, "w") as f:
        for i in range(n_reads):
            kind = rng.random()
            if kind < 0.6:
                c = rng.choice(names)
                g = genome[c]
                ln = min(rng.choice([60, 100, 300, 1000, 5000, 20000]),
                         len(g) - 1)
                p = rng.randrange(0, len(g) - ln)
                s = list(g[p:p + ln])
            elif kind < 0.85:
                # chimera
                c1, c2 = rng.choice(names), rng.choice(names)
                l1 = rng.randint(30, 300)
                l2 = rng.randint(30, 300)
                l1 = min(l1, len(genome[c1]) - 1)
                l2 = min(l2, len(genome[c2]) - 1)
                p1 = rng.randrange(0, len(genome[c1]) - l1)
                p2 = rng.randrange(0, len(genome[c2]) - l2)
                part2 = genome[c2][p2:p2 + l2]
                if rng.random() < 0.5:
                    part2 = part2.translate(COMP)[::-1]
                s = list(genome[c1][p1:p1 + l1] + part2)
            elif kind < 0.95:
                # random garbage
                s = [rng.choice(BASES) for _ in range(rng.randint(20, 200))]
            else:
                # length extremes: tiny (< wordLen), near/over the 32kb
                # cap (exercises skip-with-warning and realloc analogs,
                # Query.c:81-100,148-213)
                ln = rng.choice([1, 5, 12, 14, 31990, 32000, 32001, 33000])
                c = rng.choice(names)
                g = genome[c]
                if ln <= len(g) - 1:
                    p = rng.randrange(0, len(g) - ln)
                    s = list(g[p:p + ln])
                    # long reads tile the genome piece if needed
                else:
                    reps = ln // (len(g) - 1) + 1
                    s = list((g[:-1] * reps)[:ln])
            err = rng.choice([0.0, 0.01, 0.03, 0.08, 0.15])
            for k in range(len(s)):
                r = rng.random()
                if r < err:
                    s[k] = rng.choice(BASES)
                elif r < err * 1.2:
                    s[k] = rng.choice(iupac)
            s = "".join(s)
            if rng.random() < 0.5:
                s = s.translate(COMP)[::-1]
            if fastq:
                qual = "".join(chr(33 + rng.randrange(10, 40)) for _ in s)
                f.write("@r%d\n%s\n+\n%s\n" % (i, s, qual))
            else:
                f.write(">r%d\n" % i)
                for j in range(0, len(s), 70):
                    f.write(s[j:j + 70] + "\n")


def gen_config(rng):
    args = []
    if rng.random() < 0.3:
        args += ["-L", str(rng.choice([9, 10, 11, 12]))]
    else:
        args += ["-L", "11"]
    if rng.random() < 0.3:
        args += ["-S", str(rng.randint(1, 5))]
    cfg = []
    if rng.random() < 0.3:
        cfg += ["-H", str(rng.choice([20, 100, 650]))]
    if rng.random() < 0.3:
        cfg += ["-BW", str(rng.choice([2, 3, 5, 8]))]
    if rng.random() < 0.3:
        cfg += ["-G", str(rng.choice([10, 25, 50, 100]))]
    if rng.random() < 0.3:
        cfg += ["-M", str(rng.choice([12, 25, 40]))]
    if rng.random() < 0.3:
        cfg += ["-MD", str(rng.choice([20, 50, 120]))]
    if rng.random() < 0.3:
        cfg += ["-P", rng.choice(["0.50", "0.60", "0.75",
                          "0.80", "0.90", "0.95"])]
    if rng.random() < 0.3:
        cfg += ["-X", str(rng.choice([10, 25, 60]))]
    if rng.random() < 0.25:
        cfg += ["-AGS", "N"]
    else:
        if rng.random() < 0.3:
            cfg += ["-GOC", str(rng.randint(1, 8)),
                    "-GEC", str(rng.randint(1, 4)),
                    "-RC", str(rng.randint(1, 6)),
                    "-MS", str(rng.randint(1, 3))]
    mode = rng.random()
    if mode < 0.2:
        cfg += ["-OQC", "N"]
    elif mode < 0.5:
        cfg += ["-FBS", "Y"]
        if rng.random() < 0.5:
            cfg += ["-PRL", rng.choice(["0.25", "0.50", "0.75",
                                        "0.90"]),
                    "-PSS", rng.choice(["0.10", "0.50",
                                        "0.75", "0.90"])]
    if rng.random() < 0.3:
        cfg += ["-BP", str(rng.randint(1, 12)),
                "-MGDP", str(rng.randint(1, 9)),
                "-MNO", str(rng.choice([5, 25, 60]))]
    out = rng.choice(["-osh", "-oss", "-o8"])
    return args, cfg, out


def run_one(seed, keep=False):
    rng = random.Random(seed)
    d = tempfile.mkdtemp(prefix="fuzz%d_" % seed)
    try:
        gpath = os.path.join(d, "g.fasta")
        genome = gen_genome(rng, gpath)
        fastq = rng.random() < 0.25
        rpath = os.path.join(d, "reads.fastq" if fastq else "reads.fasta")
        gen_reads(rng, genome, rpath, fastq=fastq)
        reads_name = os.path.basename(rpath)
        idx_args, cfg, out_mode = gen_config(rng)
        # Index with the reference (already byte-parity-tested; keeps the
        # fuzz focused on alignment).
        try:
            r = subprocess.run([YAHA, "-g", "g.fasta"] + idx_args, cwd=d,
                               capture_output=True, timeout=300)
        except subprocess.TimeoutExpired:
            return "index-fail", d
        if r.returncode != 0:
            return "index-fail", d
        idx = [f for f in os.listdir(d) if ".X" in f][0]
        ref_cmd = [YAHA, "-x", idx, "-q", reads_name] + cfg + \
            [out_mode, "ref.out"]
        try:
            r1 = subprocess.run(ref_cmd, cwd=d, capture_output=True,
                                timeout=300)
        except subprocess.TimeoutExpired:
            # Reference ground to a halt (pathological repeat/IUPAC
            # inputs); nothing to diff against.
            return "ref-timeout", d
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        r_eng = rng.random()
        if r_eng < 0.55:
            engine = ["--engine", "native"]
        elif r_eng < 0.70:
            engine = ["--engine", "native", "-t", "2"]
        elif r_eng < 0.78:
            engine = ["--engine", "native", "--batch-size", "64"]
        elif r_eng < 0.84:
            # Staged engine (native host phases + jit DP batches) on
            # CPU jax; the compile cache keeps repeat shapes warm.
            engine = ["--engine", "batch-xla"]
            env["JAX_PLATFORMS"] = "cpu"
        elif r_eng < 0.90:
            # Composed path: device seed phase (phantom quirk, capacity
            # tiers, host-scan fallback) feeding the staged chaining.
            engine = ["--engine", "batch-xla", "--seed", "device"]
            env["JAX_PLATFORMS"] = "cpu"
        else:
            # Explicit: the CLI default is now the native engine, so the
            # oracle path needs its own arm to keep getting fuzzed.
            engine = ["--engine", "oracle"]
        my_cmd = [sys.executable, "-m", "yaha_tpu.cli", "-x", idx, "-q",
                  reads_name] + engine + cfg + [out_mode, "my.out"]
        if r1.returncode < 0:
            # Reference crashed; skip before burning time on our run
            # (these inputs are pathological 32kb-tandem-repeat /
            # IUPAC-heavy cases where the reference segfaults and any
            # correct aligner grinds through millions of fragments).
            return "ref-crash", d
        try:
            r2 = subprocess.run(my_cmd, cwd=d, env=env,
                                capture_output=True, timeout=1200)
        except subprocess.TimeoutExpired:
            return "OUR-TIMEOUT", d
        if r1.returncode < 0:
            # Reference crashed (observed: segfaults on IUPAC-heavy
            # inputs with small -BW, and on 32kb tandem-repeat reads).
            # No reference output to match regardless of our outcome.
            return "ref-crash", d
        if r1.returncode != 0 or r2.returncode != 0:
            return ("crash ref=%d mine=%d: %s" %
                    (r1.returncode, r2.returncode,
                     r2.stderr.decode()[-400:]), d)
        with open(os.path.join(d, "ref.out")) as f:
            ref = [l for l in f if not l.startswith("@PG")]
        with open(os.path.join(d, "my.out")) as f:
            mine = [l for l in f if not l.startswith("@PG")]
        if ref != mine:
            return "DIFF", d
        return None, d
    finally:
        if not keep:
            shutil.rmtree(d, ignore_errors=True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    fails = []
    for k in range(n):
        seed = seed0 + k
        res, d = run_one(seed, keep=False)
        if res == "ref-crash":
            print("seed %d: reference crashed; skipping" % seed, flush=True)
            continue
        if res is not None and res != "index-fail":
            res2, d2 = run_one(seed, keep=True)  # keep artifacts
            print("seed %d: %s (artifacts in %s)" % (seed, res, d2),
                  flush=True)
            fails.append(seed)
        elif (k + 1) % 10 == 0:
            print("...%d/%d ok" % (k + 1, n), flush=True)
    print("done: %d/%d failures %s" % (len(fails), n, fails))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
