"""On-device run-length decode of packed DP backtrack planes.

The information the host consumes from a DP problem is its run-length
EditOp list, a few hundred bytes, while the backtrack plane it is read
from is (rows x band) bytes.  This module performs the backtrack walk on
the device, over the kernels' problem-minor planes ([rows, band, N]) as
they are, and ships only the packed (op, run_length) items.

Walk semantics are exactly ops/dp_common.traceback_*_packed (themselves
twins of the reference backtrack, SW.cpp:1137-1195), verified
bit-identical in tests/test_decode_jax.py:

  * delete runs and match/replace runs jump whole runs per loop step;
    run lengths are reconstructed from the packed continue-bit chains
    with vectorized prefix ops (a delete run's entry cell is its
    rightmost, so its stored run counter equals the distance to the last
    clear-CD cell in the row; a match run's length is the distance to
    the last op change up its movement axis);
  * insert runs (rare: capped at maxGap, and absent from most problems)
    step one cell per iteration along the packed BT_CF chain, because
    the chain direction is diagonal in the band layouts and a whole-run
    jump would need a sheared prefix pass that costs more than the rare
    steps it saves;
  * jump lengths are capped at 255 so the precomputed jump plane stays
    uint8; capped runs take extra jumps and re-merge on emit, which is
    byte-equivalent (the host walkers merge adjacent same-op runs the
    same way, dp_common.traceback_extension_packed).

Items are emitted in walk order (from the max/anchor cell backwards),
packed as int32 (op << 28 | len); the native FMT_RLE apply
(yaha_pipe.cpp yt_batch_{ext,gap}_apply) reverses them into final list
order exactly where the plane walkers do.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .dp_common import OP_MATCH, OP_REPLACE, OP_INSERT, OP_DELETE

RLE_OP_SHIFT = 28
RLE_LEN_MASK = (1 << RLE_OP_SHIFT) - 1
JUMP_CAP = 255  # uint8 jump plane; longer runs re-merge on emit


def _jump_plane(op, cd):
    """uint8 plane of per-cell whole-run jump lengths ([h, w, n]).

    At a cell entered with op DELETE the walk consumes the delete run
    ending there: its length is the distance to the rightmost clear-CD
    cell at-or-left in the row (the kernels store BT_CD = "run continues
    one cell left", so clear-CD marks run starts).  At a cell entered
    with op MATCH/REPLACE the walk steps up (y-1, x) while the op
    repeats; that run length is the distance to the last op change up
    the column.  Cells entered with other ops jump 1.

    op/cd arrive as int8 bit fields and prefix indices use the narrowest
    dtype that holds the axis, keeping the transients (which scale with
    h*w*n) at a couple of bytes per plane cell.
    """
    h, w, n = op.shape
    xdt = jnp.int16 if w < 32768 else jnp.int32
    ydt = jnp.int16 if h < 32768 else jnp.int32
    xs = jnp.arange(w, dtype=xdt)[None, :, None]
    last0 = jax.lax.cummax(jnp.where(cd == 0, xs, xdt(-1)), axis=1)
    pd = jnp.clip(xs - last0 + 1, 1, JUMP_CAP)

    is_mr = (op >= OP_MATCH) & (op <= OP_REPLACE)
    same = (op[1:] == op[:-1]) & is_mr[1:]
    rst = jnp.concatenate([jnp.ones((1, w, n), bool), ~same], axis=0)
    ys = jnp.arange(h, dtype=ydt)[:, None, None]
    lastr = jax.lax.cummax(jnp.where(rst, ys, ydt(-1)), axis=0)
    mr = jnp.clip(ys - lastr + 1, 1, JUMP_CAP)

    return jnp.where(op == OP_DELETE, pd.astype(jnp.uint8),
                     jnp.where(is_mr, mr.astype(jnp.uint8), jnp.uint8(1)))


def _walk_loop(bt, jmp, y0, x0, active0, max_iters, cap):
    """The walk loop; returns the final while_loop state (the items in
    walk order live in state[8] as [n, cap], the per-problem item counts
    in state[7]).  A match/replace step moves (y-L, x); a delete step
    moves (y, x-L); an insert step moves (y-1, x+1) along the BT_CF
    chain.  The loop runs until every walk ended or `max_iters` (a
    traced scalar, so slices with different bounds share one program).

    The bt and jump planes are fused into ONE int16 plane (op bits 0-4,
    jump length bits 5-12) so each iteration issues a single gather."""
    h, w, n = bt.shape
    fused = (bt.astype(jnp.int16) & 31) | (jmp.astype(jnp.int16) << 5)
    fused_flat = fused.reshape(-1)
    pcol = jnp.arange(n, dtype=jnp.int32)

    def gather(y, x):
        idx = ((jnp.clip(y, 0, h - 1) * w + jnp.clip(x, 0, w - 1)) * n
               + pcol)
        return jnp.take(fused_flat, idx)

    def cond(s):
        return (s[0] < max_iters) & jnp.any(s[5])

    def body(s):
        t, y, x, ins, prev, act, run, cur, out = s
        bj = gather(y, x).astype(jnp.int32)
        b = bj & 31
        code = jnp.where(ins == 1, OP_INSERT, b & 7)
        is_end = act & (ins == 0) & (code == 0)
        do = act & ~is_end
        is_d = do & (code == OP_DELETE)
        is_i = do & (code == OP_INSERT)
        is_mr = do & (code >= OP_MATCH) & (code <= OP_REPLACE)
        jl = bj >> 5
        ln = jnp.where(is_i, 1, jl)

        # Flush the pending run when the op changes or the walk ends:
        # one O(n) scatter of the flushed entries to their slots (items
        # past `cap` are dropped; the callers' cap is a structural
        # bound).
        flush = (prev != 0) & ((do & (code != prev)) | is_end)
        entry = (prev << RLE_OP_SHIFT) | run
        out = out.at[pcol, jnp.where(flush, cur, cap)].set(entry,
                                                           mode="drop")
        cur = cur + flush
        new_run = do & ((code != prev) | (prev == 0))
        run = jnp.where(new_run, ln, jnp.where(do, run + ln, run))
        prev = jnp.where(do, code, jnp.where(is_end, 0, prev))

        y = y - jnp.where(is_mr, ln, 0) - jnp.where(is_i, 1, 0)
        x = x - jnp.where(is_d, ln, 0) + jnp.where(is_i, 1, 0)
        cf = ((b >> 4) & 1) == 1
        ins = jnp.where(is_i & cf, 1, 0)
        act = act & ~is_end
        return (t + 1, y, x, ins, prev, act, run, cur, out)

    state = (jnp.int32(0), y0.astype(jnp.int32), x0.astype(jnp.int32),
             jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
             active0, jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
             jnp.zeros((n, cap), jnp.int32))
    return jax.lax.while_loop(cond, body, state)


@functools.partial(jax.jit, static_argnames=("cap",))
def rle_decode_band(bt, y0, x0, active0, max_iters, *, cap):
    """Decode problem-minor band-layout packed planes [h, w, n] (the
    extension kernel and the band-relative anchored kernel):
    match/replace steps move (y-1, x), delete (y, x-1), insert
    (y-1, x+1).  Twin of dp_common.traceback_extension_packed /
    traceback_anchored_banded_packed up to the final list reversal,
    which the consumer applies.  Returns (rle [n, cap] int32, n_ops [n])
    with items packed op << 28 | len in walk order."""
    jmp = _jump_plane(bt & 7, (bt >> 3) & 1)
    s = _walk_loop(bt, jmp, y0, x0, active0, max_iters, cap)
    # A walk still active when the loop hit max_iters was TRUNCATED
    # (possible only if the caller's iteration bound is wrong); flag it
    # as n_ops = -1 so the host asserts instead of applying a partial
    # EditOpList (staged._device_rle).
    n_ops = jnp.where(s[5], jnp.int32(-1), s[7])
    return s[8], n_ops


@functools.partial(jax.jit, static_argnames=("cap",))
def rle_decode_rows(bt, rows, y0, x0, active0, max_iters, *, cap):
    """rle_decode_band over the problems `rows` ([L] int32) of a
    problem-minor plane [h, w, N] and their start cells ([N] each): the
    slice's planes are gathered inside the same program."""
    return rle_decode_band(jnp.take(bt, rows, axis=2), y0[rows], x0[rows],
                           active0[rows], max_iters, cap=cap)


@functools.partial(jax.jit, static_argnames=("cap", "total_pad"))
def gather_rle_flat(rle, src_aug, t_aug, starts_aug, *, cap, total_pad):
    """One-shot ragged gather of per-problem RLE item slots into a flat
    device array, so a whole bucket's items leave the device in a single
    transfer (per-tier gathers would each cost a blocking round trip).  src_aug / t_aug / starts_aug are the tier-sorted
    problem ids, their item-slot counts, and exclusive start offsets,
    augmented with one sentinel entry whose count pads the total to
    total_pad; all built host-side from the item counts."""
    m = src_aug.shape[0]
    pid = jnp.repeat(jnp.arange(m, dtype=jnp.int32), t_aug,
                     total_repeat_length=total_pad)
    base = jnp.repeat(starts_aug, t_aug, total_repeat_length=total_pad)
    srcp = jnp.take(src_aug, pid)
    pos = jnp.arange(total_pad, dtype=jnp.int64)
    idx = srcp.astype(jnp.int64) * cap + (pos - base)
    return jnp.take(rle.reshape(-1), idx, mode="clip")
