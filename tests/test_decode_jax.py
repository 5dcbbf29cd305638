"""Device RLE backtrack decode vs the host packed-plane walkers.

rle_decode_band must reproduce, run for run, what
ops/dp_common.traceback_*_packed decode from the same packed planes
(themselves twins of the reference backtrack, SW.cpp:1137-1195).  Planes
come from the Pallas kernels in interpret mode, in their problem-minor
layout; problems are random mutated copies so every op kind
(match/replace runs, deletes up to the band edge, insert chains, X-drop
early exits, score<=0 walks) appears.
"""
import os
import random

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from yaha_tpu.ops import dp_common, sw_pallas  # noqa: E402
from yaha_tpu.ops.decode_jax import (RLE_LEN_MASK, RLE_OP_SHIFT,  # noqa: E402
                                     rle_decode_band)

KW = dict(go=2, ge=1, rc=3, ms=1, max_gap=50, max_intron=100, x_cutoff=25)


def _items_from_rle(rle_row, n_ops):
    return [[dp_common.OP_CHARS[(int(e) >> RLE_OP_SHIFT) & 7],
             int(e) & RLE_LEN_MASK] for e in rle_row[:n_ops]]


def _mutate(rng, codes, n_sub, n_indel):
    out = list(codes)
    for _ in range(n_sub):
        out[rng.randrange(len(out))] = rng.randrange(4)
    for _ in range(n_indel):
        if len(out) < 2:
            break
        p = rng.randrange(1, len(out))
        if rng.random() < 0.5:
            out = out[:p] + [rng.randrange(4)] * rng.randrange(1, 4) \
                + out[p:]
        else:
            del out[p:p + rng.randrange(1, 4)]
    return out


def test_rle_decode_band_matches_host_walker():
    rng = random.Random(20260819)
    n, ql = 1024, 48
    bw2 = 2 * 4
    w = 2 * bw2 + 1
    rl = ql + 2 * bw2
    q = np.zeros((n, ql), np.uint8)
    r = np.full((n, rl), 255, np.uint8)
    qlens = np.zeros(n, np.int64)
    rlens = np.zeros(n, np.int64)
    for i in range(n):
        qn = rng.randrange(4, ql + 1)
        base = [rng.randrange(4) for _ in range(qn)]
        mut = _mutate(rng, base, rng.randrange(0, 6), rng.randrange(0, 3))
        rn = min(rl, len(mut) + rng.randrange(0, 2 * bw2))
        q[i, :qn] = base
        r[i, :rn] = (mut + [rng.randrange(4) for _ in range(rl)])[:rn]
        qlens[i] = qn
        rlens[i] = rn
    out = sw_pallas.extension_forward_pallas(
        q, qlens, r, rlens, band_width=4, interpret=True, **KW)
    bt = np.asarray(sw_pallas.problem_major(out["bt"]))
    score = np.asarray(out["score"])
    maxi = np.asarray(out["maxi"])
    maxj = np.asarray(out["maxj"])

    cap = 256
    rle, n_ops = rle_decode_band(
        out["bt"], out["maxi"], out["maxj"], out["score"] > 0,
        2 * ql + w + 16, cap=cap)
    rle = np.asarray(rle)
    n_ops = np.asarray(n_ops)

    checked_pos = checked_zero = 0
    for i in range(n):
        if score[i] <= 0:
            assert n_ops[i] == 0
            checked_zero += 1
            continue
        want, _, _ = dp_common.traceback_extension_packed(
            bt[i], maxi[i], maxj[i], score[i], bw2, reverse=True)
        got = _items_from_rle(rle[i], n_ops[i])
        assert got == want, (i, got, want)
        checked_pos += 1
    assert checked_pos > 200 and checked_zero > 0


def test_rle_decode_band_matches_anchored_banded_walker():
    rng = random.Random(7)
    n, ql, rl = 1024, 40, 48
    wband = 32
    q = np.zeros((n, ql), np.uint8)
    r = np.full((n, rl), 255, np.uint8)
    qlens = np.zeros(n, np.int64)
    rlens = np.zeros(n, np.int64)
    lbw = np.zeros(n, np.int64)
    rbw = np.zeros(n, np.int64)
    for i in range(n):
        qn = rng.randrange(2, ql + 1)
        base = [rng.randrange(4) for _ in range(qn)]
        mut = _mutate(rng, base, rng.randrange(0, 5), rng.randrange(0, 3))
        rn = max(1, min(rl, len(mut)))
        q[i, :qn] = base
        r[i, :rn] = (mut + [rng.randrange(4) for _ in range(rl)])[:rn]
        qlens[i] = qn
        rlens[i] = rn
        diff = rn - qn
        lbw[i] = min(max(4, 4 - diff), wband - 1 - max(4, 4 + diff))
        rbw[i] = max(4, 4 + diff)
        # keep the corner (qlen, rlen) inside the band
        lbw[i] = max(lbw[i], qn - rn if qn > rn else 0, 0)
        rbw[i] = max(rbw[i], rn - qn, 0)
        if lbw[i] + rbw[i] >= wband:
            rbw[i] = wband - 1 - lbw[i]
    kw = dict(go=2, ge=1, rc=3, ms=1, max_gap=50, max_intron=100)
    out = sw_pallas.anchored_forward_pallas_banded(
        q, qlens, r, rlens, lbw, rbw, wband=wband, interpret=True, **kw)
    bt_b = np.asarray(sw_pallas.problem_major(out["bt_b"]))

    cap = 256
    y0 = qlens.astype(np.int32)
    x0 = (rlens - qlens + lbw).astype(np.int32)
    rle, n_ops = rle_decode_band(
        out["bt_b"], y0, x0, np.ones(n, bool),
        2 * ql + wband + 16, cap=cap)
    rle = np.asarray(rle)
    n_ops = np.asarray(n_ops)

    for i in range(n):
        if rlens[i] - qlens[i] + lbw[i] >= wband or \
           qlens[i] - rlens[i] > lbw[i]:
            continue  # corner outside band; kernel callers never do this
        want = dp_common.traceback_anchored_banded_packed(
            bt_b[i], lbw[i], qlens[i], rlens[i])
        got = _items_from_rle(rle[i], n_ops[i])
        got.reverse()  # device emits walk order; host walker reverses
        assert got == want, (i, got, want)


def test_rle_long_runs_cap_and_merge():
    """Runs longer than JUMP_CAP (255) take several jumps and re-merge
    on emit: a clean 400-base extension must decode to one M run."""
    rng = random.Random(5)
    n, ql = 32, 400
    bw2 = 2 * 4
    rl = ql + 2 * bw2
    q = np.zeros((n, ql), np.uint8)
    r = np.full((n, rl), 255, np.uint8)
    base = [rng.randrange(4) for _ in range(ql)]
    q[0, :] = base
    r[0, :ql] = base
    qlens = np.full(n, 1, np.int64)
    rlens = np.full(n, 1, np.int64)
    qlens[0] = ql
    rlens[0] = ql
    out = sw_pallas.extension_forward_pallas(
        q, qlens, r, rlens, band_width=4, interpret=True, **KW)
    rle, n_ops = rle_decode_band(
        out["bt"], out["maxi"], out["maxj"], out["score"] > 0,
        2 * ql + 64, cap=64)
    rle = np.asarray(rle)
    n_ops = np.asarray(n_ops)
    assert n_ops[0] == 1
    assert _items_from_rle(rle[0], 1) == [["M", ql]]


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
