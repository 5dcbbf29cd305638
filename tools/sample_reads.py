#!/usr/bin/env python3
"""Sample wgsim-style reads from a .nib2 genome.

Each read is a substring of one chromosome (both strands, uniformly
placed), with errors at rate --err: 85% substitutions, 15% indels of
1-3 bases (wgsim's default indel share).  Reads overlapping an N run
are resampled.

Usage: python3 tools/sample_reads.py genome.nib2 out.fasta
           [--n 4000] [--len 1000] [--err 0.05] [--seed 1]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def sample(genome, n, length, err, rng):
    from yaha_tpu.utils import codec
    starts = np.asarray(genome.starting_offsets, np.int64)
    lens = np.asarray(genome.lengths, np.int64)
    slack = length // 4 + 16        # room for net deletions
    ok = np.nonzero(lens > length + slack)[0]
    out = []
    while len(out) < n:
        c = int(ok[rng.integers(0, len(ok))])
        pos = int(starts[c] + rng.integers(0, lens[c] - length - slack))
        src = np.asarray(genome.codes[pos:pos + length + slack], np.uint8)
        if (src > 3).any():
            continue
        parts = []
        k = 0
        for e in np.nonzero(rng.random(length) < err)[0]:
            if e < k:
                continue
            parts.append(src[k:e])
            kind = rng.random()
            if kind < 0.85:                          # substitution
                parts.append(np.asarray([(src[e] + rng.integers(1, 4))
                                         % 4], np.uint8))
                k = e + 1
            elif kind < 0.925:                       # insertion
                parts.append(rng.integers(0, 4, rng.integers(1, 4))
                             .astype(np.uint8))
                k = e
            else:                                    # deletion
                k = e + int(rng.integers(1, 4))
        parts.append(src[k:])
        r = np.concatenate(parts)[:length]
        if len(r) < length:
            continue
        if rng.random() < 0.5:
            r = codec.complement4to4(r)[::-1]
        out.append(codec.unmap4to8(r).tobytes())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("genome_nib2")
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--len", dest="length", type=int, default=1000)
    ap.add_argument("--err", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    from yaha_tpu.io import nib2
    with open(args.genome_nib2, "rb") as f:
        genome = nib2.load(f.read())
    rng = np.random.default_rng(args.seed)
    reads = sample(genome, args.n, args.length, args.err, rng)
    with open(args.out, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">rd%d_L%d\n%s\n" % (i, args.length, r))
    print("wrote %s (%d reads, %d bp, %.0f%% errors)"
          % (args.out, args.n, args.length, 100 * args.err))


if __name__ == "__main__":
    main()
