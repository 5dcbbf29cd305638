"""ctypes bindings for the native host library (libyaha_host.so).

Falls back gracefully (available() == False) when the library has not
been built; callers keep using the pure-Python implementations.  Build
with tools/build_native.sh.
"""
from __future__ import annotations

import ctypes
import os


class _LazyNumpy:
    """Defers the ~0.33s numpy import until a numpy-consuming binding is
    actually used; the numpy-free native engine never pays it."""

    def __getattr__(self, name):
        import numpy
        globals()["np"] = numpy
        return getattr(numpy, name)


np = _LazyNumpy()

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libyaha_host.so")
_lib = None


def _build_lib_once():
    """First-use auto-build of libyaha_host.so (tools/build_native.sh):
    a source checkout gets the native fast path without a manual build
    step.  A failed build (no g++, read-only tree) prints the build's
    output and leaves the Python implementations in place."""
    import subprocess
    import sys
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "tools", "build_native.sh")
    if not os.path.exists(script):
        return
    print("building native library (one-time)...", file=sys.stderr)
    try:
        r = subprocess.run(["bash", script], capture_output=True,
                           text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        print("native library build failed: %s" % e, file=sys.stderr)
        return
    if r.returncode != 0:
        print("native library build failed (rc %d):\n%s%s"
              % (r.returncode, r.stdout, r.stderr), file=sys.stderr)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build_lib_once()
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    lib.yt_compress_fasta.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.POINTER(c_u8p), c_i64p]
    lib.yt_compress_fasta_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p]
    lib.yt_unpack_nib2.argtypes = [c_u8p, ctypes.c_int64, c_u8p]
    lib.yt_parse_queries.argtypes = [
        c_u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(c_u8p), ctypes.POINTER(c_i64p),
        ctypes.POINTER(c_u8p), ctypes.POINTER(c_i64p),
        ctypes.POINTER(c_u8p), c_i64p, c_i64p]
    lib.yt_format_cigar_md.argtypes = [
        c_u8p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, c_u8p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p)]
    lib.yt_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _as_u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress_fasta(data: bytes) -> bytes:
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_int64()
    rc = lib.yt_compress_fasta(_as_u8p(arr), len(arr), ctypes.byref(out),
                               ctypes.byref(out_n))
    assert rc == 0
    try:
        return ctypes.string_at(out, out_n.value)
    finally:
        lib.yt_free(out)


def compress_fasta_file(in_path: str, out_path: str) -> None:
    """File-to-file FASTA -> nib2 (mmap in, one write out): skips the
    Python-side whole-genome byte copies of compress_fasta."""
    lib = _load()
    rc = lib.yt_compress_fasta_file(
        os.fsencode(in_path), os.fsencode(out_path))
    assert rc == 0, "yt_compress_fasta_file failed on %s" % in_path


def unpack_nib2(packed: np.ndarray) -> np.ndarray:
    lib = _load()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(len(packed) * 2, dtype=np.uint8)
    lib.yt_unpack_nib2(_as_u8p(packed), len(packed), _as_u8p(out))
    return out


def parse_queries(data: bytes, fastq: bool, max_query_len: int,
                  word_len: int):
    """Returns (ids list[str], seqs list[bytes], quals list[bytes]|None)."""
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    ids = c_u8p()
    id_offs = c_i64p()
    seqs = c_u8p()
    seq_offs = c_i64p()
    quals = c_u8p()
    n_reads = ctypes.c_int64()
    stopped = ctypes.c_int64()
    rc = lib.yt_parse_queries(
        _as_u8p(arr), len(arr), int(fastq), max_query_len, word_len,
        ctypes.byref(ids), ctypes.byref(id_offs), ctypes.byref(seqs),
        ctypes.byref(seq_offs), ctypes.byref(quals), ctypes.byref(n_reads),
        ctypes.byref(stopped))
    assert rc == 0
    n = n_reads.value
    try:
        id_off = np.ctypeslib.as_array(id_offs, shape=(n + 1,)).copy()
        seq_off = np.ctypeslib.as_array(seq_offs, shape=(n + 1,)).copy()
        id_bytes = ctypes.string_at(ids, int(id_off[-1])) if n else b""
        seq_bytes = ctypes.string_at(seqs, int(seq_off[-1])) if n else b""
        qual_bytes = (ctypes.string_at(quals, int(seq_off[-1]))
                      if (n and fastq) else b"")
    finally:
        for p in (ids, id_offs, seqs, seq_offs, quals):
            lib.yt_free(p)
    out_ids = []
    out_seqs = []
    out_quals = [] if fastq else None
    for k in range(n):
        out_ids.append(id_bytes[id_off[k]:id_off[k + 1]].decode("latin-1"))
        out_seqs.append(seq_bytes[seq_off[k]:seq_off[k + 1]])
        if fastq:
            out_quals.append(qual_bytes[seq_off[k]:seq_off[k + 1]])
    return out_ids, out_seqs, out_quals


def parse_queries_raw(data: bytes, fastq: bool, max_query_len: int,
                      word_len: int):
    """Like parse_queries but returns the flat arrays directly:
    (ids u8, id_offs i64, seqs u8, seq_offs i64, quals u8|None, n_reads).
    This is the zero-copy feed for yt_align_batch."""
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    ids = c_u8p()
    id_offs = c_i64p()
    seqs = c_u8p()
    seq_offs = c_i64p()
    quals = c_u8p()
    n_reads = ctypes.c_int64()
    stopped = ctypes.c_int64()
    rc = lib.yt_parse_queries(
        _as_u8p(arr), len(arr), int(fastq), max_query_len, word_len,
        ctypes.byref(ids), ctypes.byref(id_offs), ctypes.byref(seqs),
        ctypes.byref(seq_offs), ctypes.byref(quals), ctypes.byref(n_reads),
        ctypes.byref(stopped))
    assert rc == 0
    n = int(n_reads.value)
    try:
        id_off = (np.ctypeslib.as_array(id_offs, shape=(n + 1,)).copy()
                  if n else np.zeros(1, np.int64))
        seq_off = (np.ctypeslib.as_array(seq_offs, shape=(n + 1,)).copy()
                   if n else np.zeros(1, np.int64))
        id_arr = (np.ctypeslib.as_array(ids, shape=(int(id_off[-1]),))
                  .copy() if n and id_off[-1] else np.zeros(1, np.uint8))
        seq_arr = (np.ctypeslib.as_array(seqs, shape=(int(seq_off[-1]),))
                   .copy() if n else np.zeros(1, np.uint8))
        qual_arr = None
        if fastq and n:
            qual_arr = np.ctypeslib.as_array(
                quals, shape=(int(seq_off[-1]),)).copy()
    finally:
        for p in (ids, id_offs, seqs, seq_offs, quals):
            lib.yt_free(p)
    return id_arr, id_off, seq_arr, seq_off, qual_arr, n


class ParsedReads:
    """Zero-copy holder of yt_parse_queries output (malloc'd flat arrays);
    frees them on destruction."""

    __slots__ = ("ids", "id_offs", "seqs", "seq_offs", "quals", "n",
                 "stopped", "_lib")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        for name in ("ids", "id_offs", "seqs", "seq_offs", "quals"):
            p = getattr(self, name, None)
            if p:
                lib.yt_free(p)


def parse_queries_native(data: bytes, fastq: bool, max_query_len: int,
                         word_len: int) -> ParsedReads:
    """numpy-free parse: returns a ParsedReads owning the native arrays."""
    lib = _load()
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    pr = ParsedReads()
    pr._lib = lib
    pr.ids = c_u8p()
    pr.id_offs = c_i64p()
    pr.seqs = c_u8p()
    pr.seq_offs = c_i64p()
    pr.quals = c_u8p()
    n_reads = ctypes.c_int64()
    stopped = ctypes.c_int64()
    rc = lib.yt_parse_queries(
        ctypes.cast(ctypes.c_char_p(data), c_u8p), len(data), int(fastq),
        max_query_len, word_len,
        ctypes.byref(pr.ids), ctypes.byref(pr.id_offs),
        ctypes.byref(pr.seqs), ctypes.byref(pr.seq_offs),
        ctypes.byref(pr.quals), ctypes.byref(n_reads),
        ctypes.byref(stopped))
    assert rc == 0
    pr.n = int(n_reads.value)
    pr.stopped = bool(stopped.value)
    return pr


def _pack_params_ct(aa, n_threads):
    ip = (ctypes.c_int64 * 27)(
        aa.word_len, aa.max_hits, aa.max_gap, aa.max_intron, aa.min_match,
        aa.max_desert, aa.min_raw_score, aa.min_non_overlap,
        aa.oqc_min_non_overlap, aa.band_width, aa.m_score, aa.r_cost,
        aa.go_cost, aa.ge_cost, aa.x_cutoff, aa.min_ext_length, aa.bp_cost,
        aa.max_bp_log, int(aa.oqc), int(aa.fbs), int(aa.output_sam),
        int(aa.output_blast8), int(aa.hard_clip), int(aa.fastq),
        int(n_threads), int(aa.max_query_length),
        int(getattr(aa, "max_region_frags", 0)))
    fp = (ctypes.c_double * 3)(aa.min_identity, aa.fbs_ps_length,
                               aa.fbs_ps_score)
    return ip, fp


def _ab_sig(lib):
    import ctypes as ct
    if not hasattr(lib, "_ab_sig_done"):
        u8p, i64p = ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int64)
        lib.yt_align_batch.argtypes = [
            u8p, i64p, u8p, i64p, u8p, ct.c_int64,
            u8p, ct.c_int64, ct.c_int64,
            i64p, i64p, ct.c_int64, u8p, i64p,
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32), ct.c_int64,
            i64p, ct.POINTER(ct.c_double),
            ct.POINTER(ct.c_void_p), i64p,
            ct.POINTER(ct.c_void_p), i64p, i64p, i64p, i64p]
        lib._ab_sig_done = True


def align_batch_native(pr: ParsedReads, lo: int, hi: int, genome, index,
                       aa, n_threads=1, want_stats=False, dist=None):
    """Full native pipeline over reads [lo, hi) of a ParsedReads, using
    numpy-free NativeGenome/NativeIndex handles (io/native_loader.py).

    Returns (sam_bytes, stats_bytes|None, total_seed_matches,
    total_records); stats rows are the QUERYSTATS TSV fields.  `dist`,
    if given, is a ctypes (c_int64 * 11) array filled with the per-batch
    STATS distributions (Query.c:275-289): [queries, qlen_tot, qlen_min,
    qlen_max, count_tot, count_min, count_max, nonaligned, clumps_tot,
    clumps_min, clumps_max] (mins are INT64_MAX / max clumps -1 when
    empty)."""
    lib = _load()
    import ctypes as ct
    _ab_sig(lib)
    ip, fp = _pack_params_ct(aa, n_threads)

    def off64(p, k):
        return ct.cast(ct.cast(p, ct.c_void_p).value + 8 * k,
                       ct.POINTER(ct.c_int64))

    out_text = ct.c_void_p()
    out_len = ct.c_int64()
    stats_text = ct.c_void_p()
    stats_lenv = ct.c_int64()
    seed_total = ct.c_int64()
    rec_total = ct.c_int64()
    rc = lib.yt_align_batch(
        pr.seqs, off64(pr.seq_offs, lo), pr.ids, off64(pr.id_offs, lo),
        pr.quals if aa.fastq else None, hi - lo,
        ct.cast(genome.codes_buf, ct.POINTER(ct.c_uint8)),
        genome.codes_len, genome.max_roff,
        ct.cast(genome._starts_arr, ct.POINTER(ct.c_int64)),
        ct.cast(genome._lens_arr, ct.POINTER(ct.c_int64)), genome.n_seqs,
        ct.cast(genome._names_blob, ct.POINTER(ct.c_uint8)),
        ct.cast(genome._name_offs, ct.POINTER(ct.c_int64)),
        index.so_ptr, index.roa_ptr, index.roa_len,
        ct.cast(ip, ct.POINTER(ct.c_int64)),
        ct.cast(fp, ct.POINTER(ct.c_double)),
        ct.byref(out_text), ct.byref(out_len),
        ct.byref(stats_text) if want_stats else None,
        ct.byref(stats_lenv) if want_stats else None,
        ct.byref(seed_total), ct.byref(rec_total),
        ct.cast(dist, ct.POINTER(ct.c_int64)) if dist is not None
        else None)
    assert rc == 0
    try:
        text = ctypes.string_at(out_text, out_len.value)
    finally:
        lib.yt_free(out_text)
    stats = None
    if want_stats:
        try:
            stats = ctypes.string_at(stats_text, stats_lenv.value)
        finally:
            lib.yt_free(stats_text)
    return text, stats, int(seed_total.value), int(rec_total.value)


def _genome_handles(genome):
    """Cache flat ctypes-ready views of a Genome for yt_align_batch."""
    h = getattr(genome, "_native_handles", None)
    if h is None:
        names_blob = "".join(genome.names).encode("latin-1")
        name_offs = np.zeros(len(genome.names) + 1, np.int64)
        for i, nm in enumerate(genome.names):
            name_offs[i + 1] = name_offs[i] + len(nm)
        h = (np.ascontiguousarray(genome.codes, np.uint8),
             np.ascontiguousarray(genome.starting_offsets, np.int64),
             np.ascontiguousarray(genome.lengths, np.int64),
             np.frombuffer(names_blob + b"\0", np.uint8),
             name_offs)
        try:
            object.__setattr__(genome, "_native_handles", h)
        except AttributeError:
            pass
    return h


def _pack_params(aa, n_threads):
    import ctypes as ct
    ip = np.array([
        aa.word_len, aa.max_hits, aa.max_gap, aa.max_intron, aa.min_match,
        aa.max_desert, aa.min_raw_score, aa.min_non_overlap,
        aa.oqc_min_non_overlap, aa.band_width, aa.m_score, aa.r_cost,
        aa.go_cost, aa.ge_cost, aa.x_cutoff, aa.min_ext_length, aa.bp_cost,
        aa.max_bp_log, int(aa.oqc), int(aa.fbs), int(aa.output_sam),
        int(aa.output_blast8), int(aa.hard_clip), int(aa.fastq),
        int(n_threads), int(aa.max_query_length)], np.int64)
    fp = np.array([aa.min_identity, aa.fbs_ps_length, aa.fbs_ps_score],
                  np.float64)
    return ip, fp


def build_index(genome, word_len, skip_dist, max_hits, n_threads=4):
    """Threaded native index build (yt_build_index); byte-exact with
    index/build.build_index.  Returns (so uint32, roa uint32, total)."""
    lib = _load()
    import ctypes as ct
    if not hasattr(lib, "_bi_sig"):
        u32p = ct.POINTER(ct.c_uint32)
        lib.yt_build_index.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(u32p), ct.POINTER(u32p), ct.POINTER(ct.c_int64)]
        lib._bi_sig = True
    codes = np.ascontiguousarray(genome.codes, np.uint8)
    starts = np.ascontiguousarray(genome.starting_offsets, np.int64)
    lens = np.ascontiguousarray(genome.lengths, np.int64)
    u32p = ct.POINTER(ct.c_uint32)
    so_p = u32p()
    roa_p = u32p()
    total = ct.c_int64()
    rc = lib.yt_build_index(
        _as_u8p(codes), len(codes),
        starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        lens.ctypes.data_as(ct.POINTER(ct.c_int64)), genome.n_seqs,
        word_len, skip_dist, max_hits, n_threads,
        ct.byref(so_p), ct.byref(roa_p), ct.byref(total))
    assert rc == 0
    ht = 1 << (2 * word_len)
    try:
        so = np.ctypeslib.as_array(so_p, shape=(ht + 1,)).copy()
        roa = np.ctypeslib.as_array(
            roa_p, shape=(max(int(total.value), 1),))[
                :int(total.value)].copy()
    finally:
        lib.yt_free(so_p)
        lib.yt_free(roa_p)
    return so, roa, int(total.value)


def format_cigar_md(ops, lens, genome_codes: np.ndarray,
                    ref_off: int) -> tuple[str, str]:
    lib = _load()
    ops_arr = np.frombuffer("".join(ops).encode("latin-1"), dtype=np.uint8)
    lens_arr = np.asarray(lens, dtype=np.int32)
    cigar = ctypes.c_char_p()
    md = ctypes.c_char_p()
    rc = lib.yt_format_cigar_md(
        _as_u8p(ops_arr), lens_arr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), len(ops_arr),
        _as_u8p(np.ascontiguousarray(genome_codes)), ref_off,
        ctypes.byref(cigar), ctypes.byref(md))
    assert rc == 0
    return cigar.value.decode(), md.value.decode()


def extension_forward(q, qlens, r, rlens, *, band_width, go, ge, rc, ms,
                      max_gap, max_intron, x_cutoff):
    """C-speed batched extension forward; same contract as
    ops.sw_batch.batched_extension_forward."""
    lib = _load()
    import ctypes as ct
    n, qlmax = q.shape
    rlmax = r.shape[1]
    bw2 = 2 * band_width
    w = 2 * bw2 + 1
    q = np.ascontiguousarray(q, np.uint8)
    r = np.ascontiguousarray(r, np.uint8)
    qlens32 = np.ascontiguousarray(qlens, np.int32)
    rlens32 = np.ascontiguousarray(rlens, np.int32)
    eo = np.zeros((n, qlmax + 1, w), np.int8)
    idc = np.zeros((n, qlmax + 1, w), np.int32)
    score = np.zeros(n, np.int32)
    maxi = np.zeros(n, np.int32)
    maxj = np.zeros(n, np.int32)
    if not hasattr(lib, "_ext_sig"):
        lib.yt_extension_forward.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
            ct.c_int, ct.c_int, ct.c_int,
            ct.POINTER(ct.c_int8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32)]
        lib._ext_sig = True

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    rcode = lib.yt_extension_forward(
        p(q, ct.c_uint8), p(qlens32, ct.c_int32), p(r, ct.c_uint8),
        p(rlens32, ct.c_int32), n, qlmax, rlmax, band_width, go, ge, rc,
        ms, max_gap, max_intron, x_cutoff,
        p(eo, ct.c_int8), p(idc, ct.c_int32), p(score, ct.c_int32),
        p(maxi, ct.c_int32), p(maxj, ct.c_int32))
    assert rcode == 0
    return {"score": score, "maxi": maxi, "maxj": maxj, "eo": eo,
            "idc": idc}


def anchored_forward(q, qlens, r, rlens, left_bw, right_bw, *, go, ge, rc,
                     ms, max_gap, max_intron):
    """C-speed batched anchored (gap-fill) forward; same contract as
    ops.sw_batch.batched_anchored_forward."""
    lib = _load()
    import ctypes as ct
    n, qlmax = q.shape
    rlmax = r.shape[1]
    wid = rlmax + 1
    q = np.ascontiguousarray(q, np.uint8)
    r = np.ascontiguousarray(r, np.uint8)
    qlens32 = np.ascontiguousarray(qlens, np.int32)
    rlens32 = np.ascontiguousarray(rlens, np.int32)
    lbw32 = np.ascontiguousarray(left_bw, np.int32)
    rbw32 = np.ascontiguousarray(right_bw, np.int32)
    eo = np.zeros((n, qlmax + 1, wid), np.int8)
    idc = np.zeros((n, qlmax + 1, wid), np.int32)
    score = np.full(n, -(0x7FFFFF00), np.int32)
    if not hasattr(lib, "_anc_sig"):
        lib.yt_anchored_forward.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
            ct.POINTER(ct.c_int8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32)]
        lib._anc_sig = True

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    rcode = lib.yt_anchored_forward(
        p(q, ct.c_uint8), p(qlens32, ct.c_int32), p(r, ct.c_uint8),
        p(rlens32, ct.c_int32), p(lbw32, ct.c_int32), p(rbw32, ct.c_int32),
        n, qlmax, rlmax, go, ge, rc, ms, max_gap, max_intron,
        p(eo, ct.c_int8), p(idc, ct.c_int32), p(score, ct.c_int32))
    assert rcode == 0
    return {"score": score, "eo": eo, "idc": idc}


def chain_dp(sqo, eqo, diag, length, *, max_gap, max_desert, m_score,
             go_cost, ge_cost):
    """C-speed fragment-chain DP (buildBestClumpFromFragmentRange,
    GraphPath.cpp:161-270) over one sorted node range.

    Returns (best_idx, best_score, prev_idx, path_length, path_sqo);
    best_idx is -1 for an empty range.
    """
    lib = _load()
    import ctypes as ct
    n = len(sqo)
    sqo = np.ascontiguousarray(sqo, np.int64)
    eqo = np.ascontiguousarray(eqo, np.int64)
    diag = np.ascontiguousarray(diag, np.int64)
    length = np.ascontiguousarray(length, np.int64)
    best_score = np.empty(n, np.int64)
    prev_idx = np.empty(n, np.int64)
    path_length = np.empty(n, np.int64)
    path_sqo = np.empty(n, np.int64)
    if not hasattr(lib, "_chain_sig"):
        lib.yt_chain_dp.argtypes = [ct.c_int64] + \
            [ct.POINTER(ct.c_int64)] * 4 + [ct.c_int64] * 5 + \
            [ct.POINTER(ct.c_int64)] * 4
        lib.yt_chain_dp.restype = ct.c_int64
        lib._chain_sig = True

    def p(a):
        return a.ctypes.data_as(ct.POINTER(ct.c_int64))

    best = lib.yt_chain_dp(n, p(sqo), p(eqo), p(diag), p(length),
                           max_gap, max_desert, m_score, go_cost, ge_cost,
                           p(best_score), p(prev_idx), p(path_length),
                           p(path_sqo))
    return int(best), best_score, prev_idx, path_length, path_sqo


def _tb_sig(lib):
    import ctypes as ct
    if not hasattr(lib, "_tbb_sig"):
        lib.yt_traceback_anchored_batch.argtypes = [
            ct.POINTER(ct.c_int8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.c_int64]
        lib.yt_traceback_extension_batch.argtypes = [
            ct.POINTER(ct.c_int8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint8),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.c_int64]
        lib.yt_traceback_extension_packed_batch.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint8),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.c_int64]
        lib.yt_traceback_anchored_banded_packed_batch.argtypes = [
            ct.POINTER(ct.c_int8),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.c_int64]
        lib._tbb_sig = True


def _tb_items(ops_b, lens, lo, hi):
    return [[ops_b[i], lens[i]] for i in range(lo, hi)]


def traceback_anchored_batch(eo, idc, qlens, rlens):
    """Batched anchored run-length decode; returns list of items lists
    (same content as dp_common.traceback_anchored per problem)."""
    lib = _load()
    import ctypes as ct
    _tb_sig(lib)
    eo = np.ascontiguousarray(eo, np.int8)
    idc = np.ascontiguousarray(idc, np.int32)
    n, eo_h, eo_w = eo.shape
    qlens = np.ascontiguousarray(qlens, np.int64)
    rlens = np.ascontiguousarray(rlens, np.int64)
    cap = int(np.sum(qlens + rlens) + 2 * n + 8)
    ops = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.int32)
    offs = np.empty(n + 1, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    rc = lib.yt_traceback_anchored_batch(
        p(eo, ct.c_int8), p(idc, ct.c_int32), p(qlens, ct.c_int64),
        p(rlens, ct.c_int64), n, eo_h, eo_w,
        p(ops, ct.c_uint8), p(lens, ct.c_int32), p(offs, ct.c_int64), cap)
    assert rc == 0
    used = int(offs[n])
    ops_b = ops[:used].tobytes().decode("latin1")
    lens = lens[:used].tolist()
    offs = offs.tolist()
    return [_tb_items(ops_b, lens, offs[k], offs[k + 1]) for k in range(n)]


def traceback_extension_batch(eo, idc, maxi, maxj, score, reverse):
    """Batched extension run-length decode; per-problem items match
    dp_common.traceback_extension (empty list when score <= 0)."""
    lib = _load()
    import ctypes as ct
    _tb_sig(lib)
    eo = np.ascontiguousarray(eo, np.int8)
    idc = np.ascontiguousarray(idc, np.int32)
    n, eo_h, eo_w = eo.shape
    maxi = np.ascontiguousarray(maxi, np.int32)
    maxj = np.ascontiguousarray(maxj, np.int32)
    score = np.ascontiguousarray(score, np.int32)
    reverse = np.ascontiguousarray(reverse, np.uint8)
    cap = int(n * (eo_h + eo_w + 2) + 8)

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    while True:
        ops = np.empty(cap, np.uint8)
        lens = np.empty(cap, np.int32)
        offs = np.empty(n + 1, np.int64)
        rc = lib.yt_traceback_extension_batch(
            p(eo, ct.c_int8), p(idc, ct.c_int32), p(maxi, ct.c_int32),
            p(maxj, ct.c_int32), p(score, ct.c_int32), p(reverse, ct.c_uint8),
            n, eo_h, eo_w,
            p(ops, ct.c_uint8), p(lens, ct.c_int32), p(offs, ct.c_int64),
            cap)
        if rc == 0:
            break
        # A path alternating 1-base inserts/deletes can emit up to ~2*qlen
        # runs per problem, exceeding the (eo_h + eo_w + 2) estimate; retry
        # with a doubled buffer instead of aborting.
        cap *= 2
    used = int(offs[n])
    ops_b = ops[:used].tobytes().decode("latin1")
    lens = lens[:used].tolist()
    offs = offs.tolist()
    return [_tb_items(ops_b, lens, offs[k], offs[k + 1]) for k in range(n)]


def traceback_anchored_banded_packed_batch(bt_b, qlens, rlens, lbws):
    """Batched anchored packed-plane decode in band-relative layout
    (band-relative column o = j - i + lbw)."""
    lib = _load()
    import ctypes as ct
    _tb_sig(lib)
    bt_b = np.ascontiguousarray(bt_b, np.int8)
    n, eo_h, eo_w = bt_b.shape
    qlens = np.ascontiguousarray(qlens, np.int64)
    rlens = np.ascontiguousarray(rlens, np.int64)
    lbws = np.ascontiguousarray(lbws, np.int64)
    cap = int(np.sum(qlens + rlens) + 2 * n + 8)
    ops = np.empty(cap, np.uint8)
    lens = np.empty(cap, np.int32)
    offs = np.empty(n + 1, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    rc = lib.yt_traceback_anchored_banded_packed_batch(
        p(bt_b, ct.c_int8), p(qlens, ct.c_int64), p(rlens, ct.c_int64),
        p(lbws, ct.c_int64), n, eo_h, eo_w,
        p(ops, ct.c_uint8), p(lens, ct.c_int32), p(offs, ct.c_int64), cap)
    assert rc == 0
    used = int(offs[n])
    ops_b = ops[:used].tobytes().decode("latin1")
    lens = lens[:used].tolist()
    offs = offs.tolist()
    return [_tb_items(ops_b, lens, offs[k], offs[k + 1]) for k in range(n)]


def traceback_extension_packed_batch(bt, maxi, maxj, score, reverse):
    """Packed-plane twin of traceback_extension_batch."""
    lib = _load()
    import ctypes as ct
    _tb_sig(lib)
    bt = np.ascontiguousarray(bt, np.int8)
    n, eo_h, eo_w = bt.shape
    maxi = np.ascontiguousarray(maxi, np.int32)
    maxj = np.ascontiguousarray(maxj, np.int32)
    score = np.ascontiguousarray(score, np.int32)
    reverse = np.ascontiguousarray(reverse, np.uint8)
    cap = int(n * (eo_h + eo_w + 2) + 8)

    def p(a, t):
        return a.ctypes.data_as(ct.POINTER(t))

    while True:
        ops = np.empty(cap, np.uint8)
        lens = np.empty(cap, np.int32)
        offs = np.empty(n + 1, np.int64)
        rc = lib.yt_traceback_extension_packed_batch(
            p(bt, ct.c_int8), p(maxi, ct.c_int32),
            p(maxj, ct.c_int32), p(score, ct.c_int32),
            p(reverse, ct.c_uint8), n, eo_h, eo_w,
            p(ops, ct.c_uint8), p(lens, ct.c_int32), p(offs, ct.c_int64),
            cap)
        if rc == 0:
            break
        cap *= 2
    used = int(offs[n])
    ops_b = ops[:used].tobytes().decode("latin1")
    lens = lens[:used].tolist()
    offs = offs.tolist()
    return [_tb_items(ops_b, lens, offs[k], offs[k + 1]) for k in range(n)]


def _set_region_cap(lib, aa):
    """Propagate --max-region-frags (0 = off) to the C region loop's
    thread-local cap; oversized regions are then skipped and counted
    (drained by take_skipped_regions)."""
    import ctypes as ct
    if not hasattr(lib, "_mrf_sig"):
        lib.yt_set_max_region_frags.argtypes = [ct.c_int64]
        lib.yt_set_max_region_frags.restype = None
        lib.yt_take_skipped_regions.argtypes = []
        lib.yt_take_skipped_regions.restype = ct.c_int64
        lib._mrf_sig = True
    lib.yt_set_max_region_frags(int(getattr(aa, "max_region_frags", 0)))


def take_skipped_regions():
    """Number of regions skipped by the --max-region-frags valve since
    the last call (this thread)."""
    lib = _load()
    if not hasattr(lib, "_mrf_sig"):
        return 0
    return int(lib.yt_take_skipped_regions())


def frags_to_clumps(sqo, eqo, sro, query_len, aa):
    """C-speed fragment->clump stage (processFragmentsGapped,
    QueryMatch.c:224-303 + GraphPath.cpp:272-292 + AlignHelpers.c:48-193)
    for one strand.  Returns (clump_offs, out_sqo, out_eqo, out_sro,
    matched) with clumps in emission order, or None on capacity overflow
    (caller falls back to the Python path).
    """
    lib = _load()
    import ctypes as ct
    n = len(sqo)
    sqo = np.ascontiguousarray(sqo, np.int64)
    eqo = np.ascontiguousarray(eqo, np.int64)
    sro = np.ascontiguousarray(sro, np.int64)
    cap_frags = 16 * n + 1024
    cap_clumps = 4 * n + 64
    out_sqo = np.empty(cap_frags, np.int64)
    out_eqo = np.empty(cap_frags, np.int64)
    out_sro = np.empty(cap_frags, np.int64)
    clump_offs = np.empty(cap_clumps + 1, np.int64)
    matched = np.empty(cap_clumps, np.int64)
    if not hasattr(lib, "_f2c_sig"):
        lib.yt_frags_to_clumps.argtypes = \
            [ct.POINTER(ct.c_int64)] * 3 + [ct.c_int64] * 11 + \
            [ct.POINTER(ct.c_int64)] * 5 + [ct.c_int64] * 2
        lib.yt_frags_to_clumps.restype = ct.c_int64
        lib._f2c_sig = True

    def p(a):
        return a.ctypes.data_as(ct.POINTER(ct.c_int64))

    _set_region_cap(lib, aa)
    nc = lib.yt_frags_to_clumps(
        p(sqo), p(eqo), p(sro), n, query_len,
        aa.max_gap, aa.max_desert, aa.min_match, aa.min_non_overlap,
        aa.m_score, aa.go_cost, aa.ge_cost, aa.band_width, aa.word_len,
        p(out_sqo), p(out_eqo), p(out_sro), p(clump_offs), p(matched),
        cap_frags, cap_clumps)
    if nc < 0:
        return None
    used = int(clump_offs[nc])
    return (clump_offs[:nc + 1], out_sqo[:used], out_eqo[:used],
            out_sro[:used], matched[:nc])


def seed_to_clumps(codes, index, aa, *, cap_frags=65536, cap_clumps=8192):
    """Fused seed->fragments->clumps for one strand (yt_seed_to_clumps).

    Returns (clump_offs, out_sqo, out_eqo, out_sro, matched, total_hits)
    or None when the native lib is unavailable or capacity is exceeded
    (caller falls back to the Python stage pipeline).  Capacity grows x8
    up to ~4M emitted fragments before giving up: highly repetitive long
    reads (tandem repeats near the 32kb cap) legitimately emit huge
    clump sets, and the unbounded Python fallback is ~100x slower there.
    """
    lib = _load()
    import ctypes as ct
    if not hasattr(lib, "_s2c_sig"):
        lib.yt_seed_to_clumps.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32), ct.c_int64,
            ct.c_int64,
            ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64,
            ct.c_int64, ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_int64)]
        lib.yt_seed_to_clumps.restype = ct.c_int64
        lib._s2c_sig = True
    codes = np.ascontiguousarray(codes, np.uint8)
    so = index.starting_offs
    roa = index.roa
    if so.dtype != np.uint32:
        so = np.ascontiguousarray(so, np.uint32)
        index.starting_offs = so
    if roa.dtype != np.uint32:
        roa = np.ascontiguousarray(roa, np.uint32)
        index.roa = roa
    out_sqo = np.empty(cap_frags, np.int64)
    out_eqo = np.empty(cap_frags, np.int64)
    out_sro = np.empty(cap_frags, np.int64)
    clump_offs = np.empty(cap_clumps + 1, np.int64)
    matched = np.empty(cap_clumps, np.int64)
    total = ct.c_int64(0)

    def p64(a):
        return a.ctypes.data_as(ct.POINTER(ct.c_int64))

    _set_region_cap(lib, aa)
    while True:
        nc = lib.yt_seed_to_clumps(
            codes.ctypes.data_as(ct.POINTER(ct.c_uint8)), len(codes),
            index.word_len,
            so.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            roa.ctypes.data_as(ct.POINTER(ct.c_uint32)), len(roa),
            aa.max_hits,
            aa.max_gap, aa.max_desert, aa.min_match, aa.min_non_overlap,
            aa.m_score, aa.go_cost, aa.ge_cost, aa.band_width,
            p64(out_sqo), p64(out_eqo), p64(out_sro), p64(clump_offs),
            p64(matched), cap_frags, cap_clumps, ct.byref(total))
        if nc >= 0:
            break
        if cap_frags >= (1 << 22):
            return None
        cap_frags *= 8
        cap_clumps *= 8
        out_sqo = np.empty(cap_frags, np.int64)
        out_eqo = np.empty(cap_frags, np.int64)
        out_sro = np.empty(cap_frags, np.int64)
        clump_offs = np.empty(cap_clumps + 1, np.int64)
        matched = np.empty(cap_clumps, np.int64)
    used = int(clump_offs[nc])
    return (clump_offs[:nc + 1], out_sqo[:used], out_eqo[:used],
            out_sro[:used], matched[:nc], int(total.value))


def collect_gaps(clumps, qs, aa):
    """Native gap-collection (yt_collect_gaps) for one read's clumps.

    Returns (offs, sqo, eqo, sro, rlen, kind, score, oplen, aux0, aux1)
    or None when unavailable / degenerate offsets (caller falls back).
    """
    lib = _load()
    import ctypes as ct
    if not hasattr(lib, "_cg_sig"):
        lib.yt_collect_gaps.argtypes = [
            ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8),
            ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64] + \
            [ct.POINTER(ct.c_int64)] * 10 + [ct.c_int64]
        lib.yt_collect_gaps.restype = ct.c_int64
        lib._cg_sig = True
    n_clumps = len(clumps)
    cl_offs = np.zeros(n_clumps + 1, np.int64)
    total = 0
    for k, c in enumerate(clumps):
        total += len(c.sfrags)
        cl_offs[k + 1] = total
    f_sqo = np.empty(total, np.int64)
    f_eqo = np.empty(total, np.int64)
    f_sro = np.empty(total, np.int64)
    cl_rev = np.empty(n_clumps, np.uint8)
    i = 0
    for k, c in enumerate(clumps):
        cl_rev[k] = 1 if c.reversed else 0
        for sf in c.sfrags:
            f_sqo[i] = sf.frag.sqo
            f_eqo[i] = sf.frag.eqo
            f_sro[i] = sf.frag.sro
            i += 1
    cap = 2 * total + 2 * n_clumps + 8
    outs = [np.empty(n_clumps + 1, np.int64)] + \
        [np.empty(cap, np.int64) for _ in range(9)]
    genome = qs.genome_codes
    fwd = np.ascontiguousarray(qs.forward_codes, np.uint8)
    rev = np.ascontiguousarray(qs.reverse_codes, np.uint8)

    def p(a):
        return a.ctypes.data_as(ct.POINTER(ct.c_int64))

    def p8(a):
        return a.ctypes.data_as(ct.POINTER(ct.c_uint8))

    rc = lib.yt_collect_gaps(
        p(cl_offs), n_clumps, p(f_sqo), p(f_eqo), p(f_sro),
        p8(genome), len(genome), p8(fwd), p8(rev), qs.query_len,
        p8(cl_rev),
        aa.m_score, aa.go_cost, aa.ge_cost, aa.r_cost, aa.band_width,
        p(outs[0]), p(outs[1]), p(outs[2]), p(outs[3]), p(outs[4]),
        p(outs[5]), p(outs[6]), p(outs[7]), p(outs[8]), p(outs[9]), cap)
    if rc < 0:
        return None
    used = int(outs[0][n_clumps])
    return [outs[0]] + [a[:used] for a in outs[1:]]
