"""Pallas kernels (interpret mode) vs their XLA twins and the native DP.

The compiled GPU kernels are checked on the card by the `gpu`-marked
tests (tests/test_gpu_parity.py) and chip_smoke.py; interpret mode runs
the same kernel bodies here against the jitted XLA twins and the native
host DP, which are themselves oracle-parity tested.

The kernels emit a packed 1-byte backtrack plane (op plus gap-run
continue bits) in problem-minor layout; problem_major + unpack_backtrack
reconstruct the twins' (eo, idc) run-length arrays exactly.  Rows past a
problem's last DP row are never written by the kernels (no walk reads
them), so plane comparisons cover rows [0, maxi] for extensions and
[0, qlen] for gap fills.
"""
import numpy as np
import pytest

from yaha_tpu.ops import sw_batch, sw_pallas, dp_common
from yaha_tpu.native import host as native_host

KW = dict(go=5, ge=2, rc=3, ms=1, max_gap=50, max_intron=50)


def _bands(n, qlens, rlens):
    lbw = np.zeros(n, np.int64)
    rbw = np.zeros(n, np.int64)
    for k in range(n):
        if k % 2 == 0:   # full-DP encoding
            lbw[k] = rbw[k] = max(qlens[k], rlens[k]) + 1
        else:            # banded with asymmetric bands (SW.cpp:855-871)
            d = 2
            if rlens[k] >= qlens[k]:
                lbw[k], rbw[k] = d, d + (rlens[k] - qlens[k])
            else:
                lbw[k], rbw[k] = d + (qlens[k] - rlens[k]), d
    return lbw, rbw


def _ext_problems(rng, n, ql, bw2, p_mut=0.15, junk=0.0):
    """Mutated-copy extension problems; a `junk` share gets an unrelated
    reference so the X-drop exits within a few rows."""
    rl = ql + 2 * bw2
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    qlens = rng.integers(1, ql + 1, n).astype(np.int64)
    r = np.zeros((n, rl), np.uint8)
    for k in range(n):
        L = qlens[k]
        if rng.random() < junk:
            r[k] = rng.integers(0, 4, rl)
            continue
        r[k, :L] = q[k, :L]
        m = rng.random(L) < p_mut
        r[k, :L][m] = rng.integers(0, 4, int(m.sum()))
        r[k, L:] = rng.integers(0, 4, rl - L)
    rlens = np.minimum(qlens + bw2, rl).astype(np.int64)
    return q, qlens, r, rlens


def _row_mask(bt_pm, last_row):
    rows = np.arange(bt_pm.shape[1])[None, :, None]
    return rows <= np.asarray(last_row)[:, None, None]


def test_extension_pallas_matches_xla():
    rng = np.random.default_rng(11)
    n, ql, bw = 96, 12, 2
    bw2 = 2 * bw
    q, qlens, r, rlens = _ext_problems(rng, n, ql, bw2)
    kw = dict(band_width=bw, x_cutoff=25, **KW)
    ref = sw_batch.batched_extension_forward(q, qlens, r, rlens, **kw)
    mine = sw_pallas.extension_forward_pallas(q, qlens, r, rlens,
                                              interpret=True, **kw)
    for key in ("score", "maxi", "maxj"):
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      np.asarray(mine[key]), err_msg=key)
    bt = np.asarray(sw_pallas.problem_major(mine["bt"]))
    assert bt.shape == (n, ql + 1, 2 * bw2 + 1)
    eo_u, idc_u = sw_pallas.unpack_backtrack(bt)
    rows = _row_mask(bt, ref["maxi"])
    np.testing.assert_array_equal(np.where(rows, np.asarray(ref["eo"]), 0),
                                  np.where(rows, eo_u, 0), err_msg="eo")
    np.testing.assert_array_equal(
        np.where(rows, np.asarray(ref["idc"]), 0),
        np.where(rows, idc_u, 0), err_msg="idc")
    # Packed walkers (python + native) vs the unpacked decode.
    ks = list(range(0, n, 7))
    for k in ks:
        want = dp_common.traceback_extension(
            np.asarray(ref["eo"])[k], np.asarray(ref["idc"])[k],
            int(ref["maxi"][k]), int(ref["maxj"][k]),
            int(ref["score"][k]), bw2, bool(k % 2))
        got = dp_common.traceback_extension_packed(
            bt[k], int(mine["maxi"][k]), int(mine["maxj"][k]),
            int(mine["score"][k]), bw2, bool(k % 2))
        assert got == want, k
    if native_host.available():
        rev = np.array([k % 2 for k in ks], np.uint8)
        items = native_host.traceback_extension_packed_batch(
            bt[ks], np.asarray(mine["maxi"])[ks],
            np.asarray(mine["maxj"])[ks], np.asarray(mine["score"])[ks],
            rev)
        for idx, k in enumerate(ks):
            want, _, _ = dp_common.traceback_extension_packed(
                bt[k], int(mine["maxi"][k]), int(mine["maxj"][k]),
                int(mine["score"][k]), bw2, bool(k % 2))
            if int(mine["score"][k]) <= 0:
                want = []
            assert items[idx] == want, k


def test_anchored_banded_pallas_matches_xla():
    """Band-relative anchored kernel vs the XLA twin: scores, unshifted
    full-matrix arrays, and both backtrack decoders (python + native)."""
    rng = np.random.default_rng(23)
    n, ql, rl = 80, 11, 14
    q = rng.integers(0, 5, (n, ql)).astype(np.uint8)
    r = rng.integers(0, 5, (n, rl)).astype(np.uint8)
    qlens = rng.integers(1, ql + 1, n).astype(np.int64)
    rlens = rng.integers(1, rl + 1, n).astype(np.int64)
    lbw, rbw = _bands(n, qlens, rlens)
    ref = sw_batch.batched_anchored_forward(q, qlens, r, rlens, lbw, rbw,
                                            **KW)
    wband = int((lbw + rbw).max()) + 1
    mine = sw_pallas.anchored_forward_pallas_banded(
        q, qlens, r, rlens, lbw, rbw, wband=wband, interpret=True, **KW)
    np.testing.assert_array_equal(np.asarray(ref["score"]),
                                  np.asarray(mine["score"]), err_msg="score")
    bt_b = np.asarray(sw_pallas.problem_major(mine["bt_b"]))
    eo_b, idc_b = sw_pallas.unpack_backtrack(bt_b)
    eo_u, idc_u = sw_pallas.unshift_anchored_banded(
        eo_b, idc_b, np.asarray(lbw), wid=rl + 1)
    rows = _row_mask(np.asarray(ref["eo"]), qlens)
    np.testing.assert_array_equal(np.where(rows, np.asarray(ref["eo"]), 0),
                                  np.where(rows, np.asarray(eo_u), 0),
                                  err_msg="eo")
    np.testing.assert_array_equal(
        np.where(rows, np.asarray(ref["idc"]), 0),
        np.where(rows, np.asarray(idc_u), 0), err_msg="idc")
    ref_eo = np.asarray(ref["eo"])
    ref_idc = np.asarray(ref["idc"])
    ks = list(range(0, n, 7))
    for k in ks:
        want = dp_common.traceback_anchored(ref_eo[k], ref_idc[k],
                                            int(qlens[k]), int(rlens[k]))
        got = dp_common.traceback_anchored_banded_packed(
            bt_b[k], int(lbw[k]), int(qlens[k]), int(rlens[k]))
        assert got == want, k
    if native_host.available():
        items = native_host.traceback_anchored_banded_packed_batch(
            bt_b[ks], qlens[ks], rlens[ks], lbw[ks])
        for idx, k in enumerate(ks):
            want = dp_common.traceback_anchored(
                ref_eo[k], ref_idc[k], int(qlens[k]), int(rlens[k]))
            assert items[idx] == want, k


@pytest.mark.parametrize("n", [1, 37, 64])
def test_wrappers_pad_batch_to_block(n):
    """Any N works: the wrappers pad to a multiple of the block and slice
    the outputs back, and a problem's result does not depend on the
    batch it rides in (same answers as inside a full 64-problem run)."""
    rng = np.random.default_rng(5)
    bw = 2
    q, qlens, r, rlens = _ext_problems(rng, 64, 10, 2 * bw)
    kw = dict(band_width=bw, x_cutoff=20, **KW)
    full = sw_pallas.extension_forward_pallas(q, qlens, r, rlens,
                                              interpret=True, **kw)
    part = sw_pallas.extension_forward_pallas(q[:n], qlens[:n], r[:n],
                                              rlens[:n], interpret=True,
                                              **kw)
    assert part["bt"].shape == (11, 9, n)
    for key in ("score", "maxi", "maxj"):
        assert part[key].shape == (n,)
        np.testing.assert_array_equal(np.asarray(full[key])[:n],
                                      np.asarray(part[key]), err_msg=key)
    lbw = np.full(64, 3, np.int64)
    rbw = np.full(64, 3, np.int64) + np.maximum(rlens - qlens, 0)
    lbw = lbw + np.maximum(qlens - rlens, 0)
    wband = int((lbw + rbw).max()) + 1
    fa = sw_pallas.anchored_forward_pallas_banded(
        q, qlens, r, rlens, lbw, rbw, wband=wband, interpret=True, **KW)
    pa = sw_pallas.anchored_forward_pallas_banded(
        q[:n], qlens[:n], r[:n], rlens[:n], lbw[:n], rbw[:n], wband=wband,
        interpret=True, **KW)
    assert pa["bt_b"].shape == (11, wband, n)
    np.testing.assert_array_equal(np.asarray(fa["score"])[:n],
                                  np.asarray(pa["score"]))


@pytest.mark.skipif(not native_host.available(),
                    reason="native host library not built")
def test_extension_xdrop_early_exit_matches_native():
    """Junk-heavy blocks (unrelated references: the X-drop fires within a
    few rows) stop their row loop early; scores, max cells and decoded
    edit ops still match the native host DP exactly."""
    rng = np.random.default_rng(3)
    n, ql, bw = 64, 40, 2
    bw2 = 2 * bw
    q, qlens, r, rlens = _ext_problems(rng, n, ql, bw2, junk=0.8)
    kw = dict(band_width=bw, x_cutoff=8, **KW)
    ref = native_host.extension_forward(q, qlens, r, rlens, **kw)
    mine = sw_pallas.extension_forward_pallas(q, qlens, r, rlens,
                                              interpret=True, **kw)
    for key in ("score", "maxi", "maxj"):
        np.testing.assert_array_equal(np.asarray(ref[key]),
                                      np.asarray(mine[key]), err_msg=key)
    # The junk really exits early: most problems end far above qlen.
    assert (np.asarray(ref["maxi"]) < qlens // 2).mean() > 0.5
    bt = np.asarray(sw_pallas.problem_major(mine["bt"]))
    for k in range(n):
        want = dp_common.traceback_extension(
            ref["eo"][k], ref["idc"][k], int(ref["maxi"][k]),
            int(ref["maxj"][k]), int(ref["score"][k]), bw2, False)
        got = dp_common.traceback_extension_packed(
            bt[k], int(mine["maxi"][k]), int(mine["maxj"][k]),
            int(mine["score"][k]), bw2, False)
        assert got == want, k
