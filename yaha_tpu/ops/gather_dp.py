"""On-device DP-problem assembly for the staged engine.

Every gap/extension problem's (q, r) code slices would otherwise be
materialized host-side and uploaded per bucket.  Both slices are just
clamped substrings of data the device can hold resident:

  * the genome codes (one upload per run; paged so gathers stay int32
    even past 2^31 codes — a 3.2 Gbp human genome is ~3.2 GB of u8
    codes in device memory),
  * the chunk's read codes (one upload of the forward rows per chunk;
    the reverse-complement rows are derived on device).

The native pipeline exports per-problem source coordinates
(yt_batch_{gap,ext}_meta2: strand row, py_slice-clamped starts/copy
counts) and the planes are gathered entirely on device — problem bytes
never cross the host link in either direction (results return as
on-device RLE items).

Reference match: the slices reproduce Query.c / AlignExtFrag.cpp problem
construction bit-exactly, including the zero-fill of out-of-range
regions (py_slice semantics, yaha_pipe.cpp arena_append) and the
whole-buffer reversal of leftward extensions.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# 256 Mcodes per page: page offsets + the largest problem length stay
# comfortably inside int32 for the 2D gather.
PAGE_BITS = 28
PAGE = 1 << PAGE_BITS
# Pages overlap by this many codes so a problem starting near a page
# boundary gathers entirely from its own page.  Problems longer than
# this are routed to the host fetch path by the caller.
PAGE_OVERLAP = 1 << 21


@jax.jit
def _strand_rows(fwd_p4, lens, comp):
    """[n, lpad/2] 4-bit-packed forward code rows -> [2n, lpad] u8
    (fwd, revcomp) interleaved rows, matching the native per-read
    rev_codes (yaha_pipe.cpp: rev[k] = kComp[fwd[len-1-k]]).  The
    packed upload halves the per-chunk h2d."""
    n, half = fwd_p4.shape
    lpad = 2 * half
    fwd = jnp.stack([fwd_p4 & 0xF, fwd_p4 >> 4],
                    axis=2).reshape(n, lpad)
    j = jnp.arange(lpad, dtype=jnp.int32)
    src = jnp.clip(lens[:, None] - 1 - j[None, :], 0, lpad - 1)
    rev = jnp.take(comp, jnp.take_along_axis(fwd, src, axis=1).astype(
        jnp.int32), axis=0).astype(jnp.uint8)
    rev = jnp.where(j[None, :] < lens[:, None], rev, jnp.uint8(4))
    return jnp.stack([fwd, rev], axis=1).reshape(2 * n, lpad)


@functools.partial(jax.jit, static_argnames=("qg", "rg", "rpad"))
def _gather(rows2, pages, q_row, q_src, q_copy, qlen,
            page_id, r_off, r_copy, rlen, rev, *, qg, rg, rpad):
    """Assemble [m, qg] / [m, rg] u8 problem planes on device.

    Element j of a problem reads source position pos = len-1-j when
    `rev` (leftward extensions reverse the whole zero-filled buffer)
    else j; positions >= the clamped copy count are the zero-fill; and
    columns past the problem length take the bucket pad value (0 for q
    and gap-r, 255 for ext-r, matching the host fetch buffers)."""
    j = jnp.arange(qg, dtype=jnp.int32)[None, :]
    pos = jnp.where(rev[:, None], qlen[:, None] - 1 - j, j)
    val = (j < qlen[:, None]) & (pos < q_copy[:, None])
    col = jnp.clip(q_src[:, None] + pos, 0, rows2.shape[1] - 1)
    q = jnp.where(val, rows2[q_row[:, None], col], jnp.uint8(0))
    jr = jnp.arange(rg, dtype=jnp.int32)[None, :]
    posr = jnp.where(rev[:, None], rlen[:, None] - 1 - jr, jr)
    valr = (jr < rlen[:, None]) & (posr < r_copy[:, None])
    colr = jnp.clip(r_off[:, None] + posr, 0, pages.shape[1] - 1)
    r = jnp.where(valr, pages[page_id[:, None], colr], jnp.uint8(0))
    if rpad:
        r = jnp.where(jr < rlen[:, None], r, jnp.uint8(rpad))
    return q, r


class DeviceCorpus:
    """Device-resident genome codes + the current chunk's strand rows."""

    def __init__(self, genome_codes: np.ndarray):
        n = len(genome_codes)
        n_pages = max(1, -(-n // PAGE))
        width = min(n, PAGE + PAGE_OVERLAP)
        pages = np.zeros((n_pages, width), np.uint8)
        for p in range(n_pages):
            lo = p * PAGE
            hi = min(lo + width, n)
            pages[p, :hi - lo] = genome_codes[lo:hi]
        self.pages = jax.device_put(pages)
        self.genome_bytes = int(pages.nbytes)
        from ..utils import codec
        self._comp = jax.device_put(
            np.asarray(codec.FOUR_BIT_COMP_CODES, np.uint8))

    def chunk_rows(self, fwd_codes: np.ndarray, lens: np.ndarray):
        """Device [2n, lpad] strand rows for one chunk (revcomp rows
        derived on device; forward rows upload 4-bit-packed).  Returned
        to the caller (NOT stored here: the CLI prefetch pipeline
        overlaps chunks, so each align_chunk call owns its rows)."""
        packed = fwd_codes[:, ::2] | (fwd_codes[:, 1::2] << 4)
        return _strand_rows(jnp.asarray(packed),
                            jnp.asarray(lens.astype(np.int32)),
                            self._comp)

    def gather(self, rows2, q_row, q_src, q_copy, qlen, r_src, r_copy,
               rlen, rev=None, *, qg, rg, rpad=0):
        """Device (q, r) planes for one pow2-tier bucket; all index
        arrays are 1-D host numpy of one length m."""
        m = len(q_row)
        if rev is None:
            rev = np.zeros(m, bool)
        page_id = (r_src >> PAGE_BITS).astype(np.int32)
        r_off = (r_src & (PAGE - 1)).astype(np.int32)
        return _gather(
            rows2, self.pages,
            jnp.asarray(q_row.astype(np.int32)),
            jnp.asarray(q_src.astype(np.int32)),
            jnp.asarray(q_copy.astype(np.int32)),
            jnp.asarray(qlen.astype(np.int32)),
            jnp.asarray(page_id), jnp.asarray(r_off),
            jnp.asarray(r_copy.astype(np.int32)),
            jnp.asarray(rlen.astype(np.int32)),
            jnp.asarray(rev.astype(bool)),
            qg=int(qg), rg=int(rg), rpad=int(rpad))
