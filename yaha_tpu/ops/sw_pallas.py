"""Pallas (Triton route) kernels for the staged engine's device DP.

Two kernels, both bit-identical to their XLA twins in ops/sw_batch.py
(tested), which are themselves bit-identical to the scalar oracle ported
from SW.cpp:

  * extension_forward_pallas — banded X-dropoff extension
    (SW.cpp:798-1208, extension tie rules);
  * anchored_forward_pallas_banded — anchored gap-fill DP in
    band-relative coordinates (SW.cpp:855-871, anchored tie rules).

Layout (both kernels): problems run across threads, BLOCK problems per
program, one problem per thread.  Every array a program loads or stores
per DP step is laid out problem-minor ([..., N]), so a warp's access is
one contiguous run of bytes: q as [QL, N], the extension reference as
[RL, N], and the packed backtrack plane as [rows, band, N].  The query
row loop runs inside the program (blocks on the GPU run in parallel and
in no order, so nothing carries between programs); it stops as soon as
every problem in the block is finished (X-dropped or past its qlen).

The extension band is narrow and static (w = 4*bandWidth + 1), so its
3 x (w + 1) int32 band state lives in registers: the column loop is
unrolled in Python and every band cell is its own SSA value.  The
anchored band is a pow2 tier up to 512 columns, too wide for registers,
so its band state lives in per-problem global scratch (three
[wband + 1, N] int32 planes, problem-minor, L1/L2 resident) and the
column loop is a loop.  The anchored reference is read per cell at a
per-problem offset, so it stays problem-major ([N, RL]): each thread
walks its own row, one cache line serving 32+ consecutive cells.

Packed backtrack byte: bits 0-2 the op code, bit 3 "delete run continues
one cell left", bit 4 "insert run continues up the chain".  The int32
run-length plane the XLA twins emit is fully reconstructible from these
bits (run length = 1 + length of the continue-bit chain), so the kernels
write 1 byte per band cell instead of 5.

Rows past the row where a block's loop stopped are never written; the
backtrack walks start at (maxi, maxj) or (qlen, rlen) and only move up,
so they never read them.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .dp_common import BT_CD, BT_CF, BT_OP  # noqa: F401 (re-exported)
from .sw_batch import (DP_WORST, OP_UNKNOWN, OP_MATCH, OP_REPLACE,
                       OP_INSERT, OP_DELETE)

# Problems per program (one per thread of a single warp).  Small blocks
# spread a batch over the most SMs; each thread's DP chain is serial.
BLOCK = 32
PARAMS = plgpu.CompilerParams(num_warps=BLOCK // 32, num_stages=1)


def _pad_to(x, n, value=0):
    """Pad axis 0 of `x` to length n."""
    if x.shape[0] == n:
        return x
    widths = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=value)


def _ext_kernel(q_ref, r_ref, qlens_ref, rlens_ref,
                bt_ref, score_ref, maxi_ref, maxj_ref,
                *, block, ql_max, w, bw2, go, ge, rc, ms, max_gap,
                max_intron, x_cutoff):
    i32 = jnp.int32
    cols = pl.ds(pl.program_id(0) * block, block)
    qlens = qlens_ref[cols]
    rlens = rlens_ref[cols]

    def full(v):
        return jnp.full((block,), v, i32)

    # Row-0 init (SW.cpp:899-933); band-edge sentinels at index w.
    pv, pf, pi = [], [], []
    for j in range(w + 1):
        if j < bw2 or j == w:
            pv.append(full(DP_WORST))
            pf.append(full(DP_WORST))
        elif j == bw2:
            pv.append(full(0))
            pf.append(full(0))
        else:
            pv.append(full(-(go + (j - bw2) * ge)))
            pf.append(full(DP_WORST))
        pi.append(full(0))
        if j < w:
            # Row-0 delete boundary: run length j - bw2, encoded as a
            # continue-bit chain back to column bw2 + 1.
            code = (OP_DELETE + (BT_CD if j - bw2 >= 2 else 0)
                    if j > bw2 else OP_UNKNOWN)
            bt_ref[0, j, cols] = jnp.full((block,), code, jnp.int8)

    def row_cond(s):
        i, done = s[0], s[-1]
        return (i <= ql_max) & (jnp.min(done) == 0)

    def row_body(s):
        i, pv, pf, pi, max_score, maxi, maxj, done = s
        pv, pf, pi = list(pv), list(pf), list(pi)
        row_active = (done == 0) & (i <= qlens)
        start_col = jnp.maximum(bw2 + 1 - i, 0)
        end_col = jnp.minimum(bw2 + rlens - i, w - 1)
        edge = i <= bw2
        edge_val = -(go + i * ge)
        # PVRow[startCol-1] edge write (only while i <= bw2).
        for j in range(bw2 + 1):
            pv[j] = jnp.where(edge & (j == bw2 - i), edge_val, pv[j])
        q_char = q_ref[i - 1, cols].astype(i32)

        pe_col = full(DP_WORST)
        pd_col = full(0)
        pv_col = jnp.where(edge, full(edge_val), full(DP_WORST))
        row_max = full(DP_WORST)
        best_v = full(DP_WORST)
        best_j = full(0)
        for j in range(w):
            active = row_active & (j >= start_col) & (j <= end_col)
            v = pv[j]
            r_char = r_ref[i - 1 + j, cols].astype(i32)
            neq = q_char != r_char
            gscore = jnp.where(neq, v - rc, v + ms)
            opcode = jnp.where(neq, OP_REPLACE, OP_MATCH)

            # Delete, checked first (SW.cpp:1026-1041).
            ce = pe_col - ge
            ne = pv_col - (go + ge)
            cont_d = (ce >= ne) & (pd_col + 1 <= max_intron)
            pe_new = jnp.where(cont_d, ce, ne)
            pd_new = jnp.where(cont_d, pd_col + 1, 1)
            take_d = pe_new >= gscore   # extension tie rule: >=
            v1 = jnp.where(take_d, pe_new, gscore)
            opcode = jnp.where(take_d, OP_DELETE, opcode)

            # Insert (SW.cpp:1043-1060).
            cf = pf[j + 1] - ge
            nf = pv[j + 1] - (go + ge)
            cont_f = (cf >= nf) & (pi[j + 1] + 1 <= max_gap)
            f = jnp.where(cont_f, cf, nf)
            ii = jnp.where(cont_f, pi[j + 1] + 1, 1)
            take_f = f >= v1
            v2 = jnp.where(take_f, f, v1)
            opcode = jnp.where(take_f, OP_INSERT, opcode)

            pf[j] = jnp.where(active, f, pf[j])
            pi[j] = jnp.where(active, ii, pi[j])
            # Run lengths are >= 1, so min(x - 1, 1) is the continue bit.
            packed = (opcode + BT_CD * jnp.minimum(pd_new - 1, 1)
                      + BT_CF * jnp.minimum(ii - 1, 1))
            # The anti-diagonal insert init lives at j == bw2 - i, below
            # startCol for this row (SW.cpp:925-933); its run length i
            # continues up the (y-1, x+1) chain of earlier init cells.
            init_cell = edge & (j == bw2 - i)
            fill = jnp.where(init_cell,
                             OP_INSERT + BT_CF * jnp.minimum(i - 1, 1),
                             OP_UNKNOWN)
            bt_ref[i, j, cols] = jnp.where(active, packed,
                                           fill).astype(jnp.int8)
            pv[j] = jnp.where(active, v2, pv[j])

            row_max = jnp.where(active, jnp.maximum(row_max, v2), row_max)
            upd = active & (v2 > best_v)
            best_v = jnp.where(upd, v2, best_v)
            best_j = jnp.where(upd, j, best_j)
            pe_col = jnp.where(active, pe_new, pe_col)
            pd_col = jnp.where(active, pd_new, pd_col)
            pv_col = jnp.where(active, v2, pv_col)

        # Global max (strict >, row-major first occurrence).
        upd = row_active & (best_v > max_score)
        max_score = jnp.where(upd, best_v, max_score)
        maxi = jnp.where(upd, i, maxi)
        maxj = jnp.where(upd, best_j, maxj)
        # X-cutoff row break (SW.cpp:1091) and the natural end of rows.
        newly_done = row_active & (row_max < max_score - x_cutoff)
        done = jnp.where(newly_done | (i >= qlens), 1, done)
        return (i + 1, tuple(pv), tuple(pf), tuple(pi), max_score, maxi,
                maxj, done)

    s = (jnp.int32(1), tuple(pv), tuple(pf), tuple(pi), full(DP_WORST),
         full(0), full(0), full(0))
    s = jax.lax.while_loop(row_cond, row_body, s)
    score_ref[cols] = s[4]
    maxi_ref[cols] = s[5]
    maxj_ref[cols] = s[6]


@functools.partial(
    jax.jit,
    static_argnames=("band_width", "go", "ge", "rc", "ms", "max_gap",
                     "max_intron", "x_cutoff", "interpret"))
def extension_forward_pallas(q, qlens, r, rlens, *, band_width, go, ge, rc,
                             ms, max_gap, max_intron, x_cutoff,
                             interpret=False):
    """Banded X-drop extension forward pass; same contract as
    sw_batch.batched_extension_forward.

    q: [N, QL] uint8, r: [N, RL] uint8 with RL >= QL + 2*bw2; any N
    (padded to the block internally).  Returns score/maxi/maxj [N] and
    the packed backtrack plane bt [QL+1, W, N] int8 (problem-minor;
    problem_major() gives [N, QL+1, W]).
    """
    n, ql_max = q.shape
    bw2 = 2 * band_width
    w = 2 * bw2 + 1
    n_pad = -(-n // BLOCK) * BLOCK
    q_t = _pad_to(q, n_pad).T
    r_t = _pad_to(jnp.pad(r, ((0, 0), (bw2, w)), constant_values=255),
                  n_pad, 255).T
    kernel = functools.partial(
        _ext_kernel, block=BLOCK, ql_max=ql_max, w=w, bw2=bw2, go=go,
        ge=ge, rc=rc, ms=ms, max_gap=max_gap, max_intron=max_intron,
        x_cutoff=x_cutoff)
    vec = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    bt, score, maxi, maxj = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((ql_max + 1, w, n_pad), jnp.int8),
                   vec, vec, vec),
        compiler_params=PARAMS,
        interpret=interpret,
        name="yaha_ext_dp",
    )(q_t, r_t, _pad_to(qlens.astype(jnp.int32), n_pad),
      _pad_to(rlens.astype(jnp.int32), n_pad))
    if n_pad != n:
        bt, score, maxi, maxj = bt[..., :n], score[:n], maxi[:n], maxj[:n]
    return {"score": score, "maxi": maxi, "maxj": maxj, "bt": bt}


def _anch_kernel(q_ref, r_ref, qlens_ref, rlens_ref, lbw_ref, rbw_ref,
                 bt_ref, score_ref, pv_ref, pf_ref, pi_ref,
                 *, block, rl_max, wband, go, ge, rc, ms, max_gap,
                 max_intron):
    """Anchored (gap-fill) DP in band-relative coordinates.

    Offset o = j - i + lbw is row-invariant per problem, so the column
    sweep is a static `wband` wide regardless of the reference length
    (the reference banded variant, SW.cpp:855-871, walks the same
    trapezoid).  Diagonal (i-1, j-1) is pv[o] before its overwrite,
    vertical (i-1, j) is pv/pf/pi[o + 1], horizontal (i, j-1) is the
    loop carry.  Per-problem bands narrower than wband are enforced by
    masks; the query-start insert boundary (column j = 0) slides through
    the band at o = lbw - i and is written in-loop.  pv/pf/pi_ref are
    this kernel's band-state scratch ([wband + 1, N] int32)."""
    i32 = jnp.int32
    pid = pl.program_id(0)
    cols = pl.ds(pid * block, block)
    prow = pid * block + jax.lax.iota(i32, block)
    qlens = qlens_ref[cols]
    rlens = rlens_ref[cols]
    lbw = lbw_ref[cols]
    rbw = rbw_ref[cols]
    bandw = lbw + rbw  # the problem's band occupies o in [0, bandw]

    def full(v):
        return jnp.full((block,), v, i32)

    # Row-0 boundary (j0 = o - lbw): origin 0 at j0 == 0, delete boundary
    # -(go + j0*ge) for 1 <= j0 <= min(rbw, rlen), DPWorst elsewhere
    # (SW.cpp:899-923 in full-matrix coordinates).
    live_hi = jnp.minimum(rbw, rlens)

    def init_col(o, carry):
        j0 = o - lbw
        live = (j0 >= 1) & (j0 <= live_hi)
        pv_ref[o, cols] = jnp.where(j0 == 0, 0, jnp.where(
            live, -(go + j0 * ge), DP_WORST))
        pf_ref[o, cols] = full(DP_WORST)
        pi_ref[o, cols] = full(0)
        # Delete boundary of run length j0: continue bit for j0 >= 2.
        bt_ref[0, o, cols] = jnp.where(
            live, OP_DELETE + BT_CD * jnp.clip(j0 - 1, 0, 1),
            OP_UNKNOWN).astype(jnp.int8)
        return carry
    jax.lax.fori_loop(0, wband, init_col, None)
    pv_ref[wband, cols] = full(DP_WORST)   # band-edge sentinel
    pf_ref[wband, cols] = full(DP_WORST)
    pi_ref[wband, cols] = full(0)

    def row_body(i, sc):
        row_active = i <= qlens
        edge_val = -(go + i * ge)
        q_char = q_ref[i - 1, cols].astype(i32)
        bound_code = OP_INSERT + BT_CF * jnp.minimum(i - 1, 1)

        def col_step(o, c):
            pe_col, pd_col, pv_col, sc, v = c   # v: diagonal (i-1, j-1)
            j = i + o - lbw
            active = row_active & (j >= 1) & (o <= bandw) & (j <= rlens)
            is_bound = row_active & (j == 0)
            up_v = pv_ref[o + 1, cols]          # vertical (i-1, j)
            up_f = pf_ref[o + 1, cols]
            up_i = pi_ref[o + 1, cols]
            r_char = r_ref[prow, jnp.clip(j - 1, 0, rl_max - 1)].astype(i32)
            neq = q_char != r_char
            gscore = jnp.where(neq, v - rc, v + ms)
            opcode = jnp.where(neq, OP_REPLACE, OP_MATCH)

            ce = pe_col - ge
            ne = pv_col - (go + ge)
            cont_d = (ce >= ne) & (pd_col + 1 <= max_intron)
            pe_new = jnp.where(cont_d, ce, ne)
            pd_new = jnp.where(cont_d, pd_col + 1, 1)
            take_d = pe_new > gscore   # anchored tie rule: strict >
            v1 = jnp.where(take_d, pe_new, gscore)
            opcode = jnp.where(take_d, OP_DELETE, opcode)

            cf = up_f - ge
            nf = up_v - (go + ge)
            cont_f = (cf >= nf) & (up_i + 1 <= max_gap)
            f = jnp.where(cont_f, cf, nf)
            ii = jnp.where(cont_f, up_i + 1, 1)
            take_f = f > v1            # anchored tie rule: strict >
            v2 = jnp.where(take_f, f, v1)
            opcode = jnp.where(take_f, OP_INSERT, opcode)

            pf_ref[o, cols] = jnp.where(active, f, DP_WORST)
            pi_ref[o, cols] = jnp.where(active, ii, 0)
            # Run lengths are >= 1, so min(x - 1, 1) is the continue bit.
            packed = (opcode + BT_CD * jnp.minimum(pd_new - 1, 1)
                      + BT_CF * jnp.minimum(ii - 1, 1))
            # Sliding insert boundary of run length i: its chain
            # continues at (i-1, o+1), the row above's boundary cell.
            bt_ref[i, o, cols] = jnp.where(
                active, packed, jnp.where(is_bound, bound_code, OP_UNKNOWN)
            ).astype(jnp.int8)
            edge_v = jnp.where(is_bound, edge_val, DP_WORST)
            pv_ref[o, cols] = jnp.where(active, v2, edge_v)
            sc = jnp.where(active & (i == qlens) & (j == rlens), v2, sc)
            return (jnp.where(active, pe_new, DP_WORST),
                    jnp.where(active, pd_new, 0),
                    jnp.where(active, v2, edge_v), sc, up_v)

        c = (full(DP_WORST), full(0), full(DP_WORST), sc, pv_ref[0, cols])
        return jax.lax.fori_loop(0, wband, col_step, c)[3]

    # Rows past the block's longest query are never needed.
    rows = jnp.max(qlens)
    score_ref[cols] = jax.lax.fori_loop(1, rows + 1, row_body,
                                        full(DP_WORST))


@functools.partial(
    jax.jit,
    static_argnames=("wband", "go", "ge", "rc", "ms", "max_gap",
                     "max_intron", "interpret"))
def anchored_forward_pallas_banded(q, qlens, r, rlens, left_bw, right_bw,
                                   *, wband, go, ge, rc, ms, max_gap,
                                   max_intron, interpret=False):
    """Band-relative anchored forward; same contract as
    sw_batch.batched_anchored_forward, with static per-row work
    O(wband) instead of O(rl_max).

    wband must be a static int >= max(left_bw + right_bw) + 1 (callers
    bucket it to limit recompiles).  Any N (padded to the block
    internally).  Returns {"score" [N], "bt_b" [QL+1, WBAND, N]} with
    the packed backtrack plane in problem-minor banded layout (column
    o = j - i + lbw); decode with decode_jax.rle_decode_band, or expand
    with problem_major + unpack_backtrack + unshift_anchored_banded to
    get arrays identical to batched_anchored_forward's.
    """
    n, ql_max = q.shape
    rl_max = r.shape[1]
    n_pad = -(-n // BLOCK) * BLOCK

    def vec(x):
        return _pad_to(x.astype(jnp.int32), n_pad)

    kernel = functools.partial(
        _anch_kernel, block=BLOCK, rl_max=rl_max, wband=wband, go=go,
        ge=ge, rc=rc, ms=ms, max_gap=max_gap, max_intron=max_intron)
    state = jax.ShapeDtypeStruct((wband + 1, n_pad), jnp.int32)
    bt_b, score, _, _, _ = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((ql_max + 1, wband, n_pad),
                                        jnp.int8),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   state, state, state),
        compiler_params=PARAMS,
        interpret=interpret,
        name="yaha_gap_dp",
    )(_pad_to(q, n_pad).T, _pad_to(r, n_pad), vec(qlens), vec(rlens),
      vec(left_bw), vec(right_bw))
    if n_pad != n:
        bt_b, score = bt_b[..., :n], score[:n]
    return {"score": score, "bt_b": bt_b}


@jax.jit
def problem_major(bt):
    """[rows, band, N] problem-minor plane -> [N, rows, band]."""
    return jnp.transpose(bt, (2, 0, 1))


def unpack_backtrack(bt):
    """Expand a packed backtrack plane to the XLA twins' (eo, idc).

    `bt` is problem-major [..., H, W] int8 with op in bits 0-2, BT_CD
    (delete run continues one cell left in the same row) in bit 3, and
    BT_CF (insert run continues up the chain) in bit 4.  The insert
    chain ascends (y-1, x+1) in both band layouts.  Run lengths are 1 +
    the length of the continue-bit chain, which is exactly the forward
    pass's pd/ii counters, so the reconstructed idc plane is
    bit-identical to the twins'.  Test/debug helper; production paths
    walk the packed plane directly.
    """
    import numpy as np
    bt = np.asarray(bt)
    eo = (bt & BT_OP).astype(np.int8)
    cd = (bt >> 3) & 1
    cf = (bt >> 4) & 1
    h, w = bt.shape[-2:]
    idx = np.arange(w, dtype=np.int64)
    # Delete runs along each row: pd[x] = x - (last x' <= x with cd 0) + 1.
    last0 = np.maximum.accumulate(np.where(cd == 0, idx, -1), axis=-1)
    pd = idx - last0 + 1
    # Insert runs up the chain: ii[y] = cf[y] ? ii[y-1, x+1] + 1 : 1.
    ii = np.ones(bt.shape, np.int64)
    for y in range(1, h):
        ii[..., y, :-1] = np.where(cf[..., y, :-1] == 1,
                                   ii[..., y - 1, 1:] + 1, 1)
    idc = np.where(eo == OP_INSERT, ii,
                   np.where(eo == OP_DELETE, pd, 0)).astype(np.int32)
    return eo, idc


@functools.partial(jax.jit, static_argnames=("wid",))
def unshift_anchored_banded(eo_b, idc_b, left_bw, wid):
    """Test helper: expand problem-major banded-layout backtrack arrays
    to full-matrix coordinates (absolute (i, j) lives at
    o = j - i + lbw), matching batched_anchored_forward's eo/idc."""
    n, qlp1, wband = eo_b.shape
    lbw32 = left_bw.astype(jnp.int32)
    ii = jnp.arange(qlp1)[None, :, None]
    jj = jnp.arange(wid)[None, None, :]
    o = jj - ii + lbw32[:, None, None]
    valid = (o >= 0) & (o < wband)
    oc = jnp.clip(o, 0, wband - 1)
    eo = jnp.where(valid, jnp.take_along_axis(eo_b, oc, axis=2),
                   jnp.int8(OP_UNKNOWN))
    idc = jnp.where(valid, jnp.take_along_axis(idc_b, oc, axis=2), 0)
    return eo, idc
