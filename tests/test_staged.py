"""Staged batch engine (native host phases + batched device DP).

Byte-parity of models/staged.StagedAligner against the per-read native
pipeline (yt_align_batch) and against the golden SAM outputs, across DP
backends and result formats:

  * native backend, inline_small on  — zero-marshalling host path
  * native backend, inline_small off — every problem through the
    fetch/apply marshalling with eo/idc (FMT_EOIDC) result planes
  * xla backend — jit DP twins, eo/idc planes
  * CLI --engine batch-xla (staged is the default frontend)

The pallas backend runs here with its kernels in interpret mode; the
compiled GPU kernels are covered on the card by tests/test_gpu_parity.py.
"""
import gzip
import os
import shutil
import subprocess
import sys

import pytest

from conftest import DATA, GOLD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    d = tmp_path_factory.mktemp("staged")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta",
              "readsD_sv.fasta", "readsE_150bp.fastq",
              "readsF_edge.fasta"):
        p = os.path.join(DATA, f)
        if os.path.exists(p):
            shutil.copy(p, d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(d, "testgen.X11_01_65525S"), "wb") as out:
            out.write(f.read())
    return d


@pytest.fixture(scope="module")
def env(scratch):
    from yaha_tpu.io import native_loader
    genome = native_loader.load_genome(
        os.path.join(scratch, "testgen.nib2"))
    index = native_loader.load_index(
        os.path.join(scratch, "testgen.X11_01_65525S"))
    return genome, index


def _make_aa(scratch, qfile, **over):
    from yaha_tpu.config import AlignmentArgs
    aa = AlignmentArgs()
    aa.xfile_name = "testgen.X11_01_65525S"
    aa.qfile_name = qfile
    aa.ofile_name = "out.sam"
    for k, v in over.items():
        setattr(aa, k, v)
    aa.post_process(True)
    return aa


def _parsed(scratch, aa):
    from yaha_tpu.native import host
    with open(os.path.join(scratch, aa.qfile_name), "rb") as f:
        data = f.read()
    aa.fastq = data[:1] == b"@"
    return host.parse_queries_native(data, aa.fastq, aa.max_query_length,
                                     aa.word_len)


CONFIGS = [
    ("readsA_100bp.fasta", {}),
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}),
    ("readsD_sv.fasta", {"fbs": True}),
    ("readsA_100bp.fasta", {"oqc": False}),           # ALL-mode dups
    ("readsE_150bp.fastq", {}),
    ("readsF_edge.fasta", {}),                        # degenerate chops
    ("readsA_100bp.fasta", {"output_blast8": True,
                            "output_sam": False}),    # Blast8 writer
    ("readsA_100bp.fasta", {"hard_clip": False}),     # soft clips
]


@pytest.mark.parametrize("qfile,over", CONFIGS,
                         ids=["default", "params1kb", "sv_fbs", "allmode",
                              "fastq", "edge", "blast8", "softclip"])
def test_staged_native_backend_parity(scratch, env, qfile, over):
    from yaha_tpu.native import host
    from yaha_tpu.models.staged import StagedAligner
    genome, index = env
    aa = _make_aa(scratch, qfile, **over)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    ref, _, sm0, nr0 = host.align_batch_native(pr, 0, pr.n, genome, index,
                                               aa, n_threads=2)
    for inline in (True, False):
        st = StagedAligner(aa, genome, index, backend="native",
                           n_threads=2, inline_small=inline)
        text, sm, nr = st.align_chunk(pr, 0, pr.n)
        assert text == ref, (qfile, over, inline)
        assert (sm, nr) == (sm0, nr0)
    if not over:
        # Marshalling actually happened on the inline=False pass.
        assert st.stats["dp_launches"] > 0
        assert st.stats["ext_problems"] > 0


def test_staged_xla_backend_parity(scratch, env):
    """jit DP twins through the staged fetch/apply path (subset of reads
    to bound CPU compile time; shapes are pow2-tiered so the compile
    cache covers reruns)."""
    from yaha_tpu.native import host
    from yaha_tpu.models.staged import StagedAligner
    genome, index = env
    aa = _make_aa(scratch, "readsA_100bp.fasta")
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    n = min(pr.n, 64)
    ref, _, sm0, nr0 = host.align_batch_native(pr, 0, n, genome, index,
                                               aa, n_threads=2)
    st = StagedAligner(aa, genome, index, backend="xla", n_threads=2)
    text, sm, nr = st.align_chunk(pr, 0, n)
    assert text == ref
    assert (sm, nr) == (sm0, nr0)


def test_staged_pallas_rle_parity_interpret(scratch, env, monkeypatch):
    """The full staged-pallas path — Pallas kernels (interpret mode),
    on-device RLE backtrack decode (ops/decode_jax.py), and the native
    FMT_RLE apply — is byte-identical to the per-read native pipeline.
    Also A/Bs the RLE path against the plane-transfer path (YT_STAGED_RLE
    = 0).  On-card coverage: tests/test_gpu_parity.py."""
    from yaha_tpu.native import host
    from yaha_tpu.models.staged import StagedAligner
    genome, index = env
    aa = _make_aa(scratch, "readsD_sv.fasta", fbs=True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    n = min(pr.n, 12)
    ref, _, sm0, nr0 = host.align_batch_native(pr, 0, n, genome, index,
                                               aa, n_threads=2)
    texts = {}
    for rle in ("1", "0"):
        monkeypatch.setenv("YT_STAGED_RLE", rle)
        st = StagedAligner(aa, genome, index, backend="pallas",
                           n_threads=2, interpret=True)
        texts[rle], sm, nr = st.align_chunk(pr, 0, n)
        assert (sm, nr) == (sm0, nr0)
    assert texts["1"] == ref
    assert texts["0"] == ref


def test_staged_pallas_routes_wide_gaps_to_twin(scratch, env,
                                                monkeypatch):
    """Gap problems whose band tier exceeds GAP_WBAND_MAX take the
    full-matrix XLA twin instead of the band-relative kernel; the split
    shows in stats and the bytes stay identical to the native engine.
    (The cap is lowered so the small test reads produce both classes.)"""
    from yaha_tpu.native import host
    from yaha_tpu.models import staged
    genome, index = env
    aa = _make_aa(scratch, "readsC_1kb.fasta")
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    n = min(pr.n, 16)
    ref, _, sm0, nr0 = host.align_batch_native(pr, 0, n, genome, index,
                                               aa, n_threads=2)
    monkeypatch.setattr(staged, "GAP_WBAND_MAX", 32)
    st = staged.StagedAligner(aa, genome, index, backend="pallas",
                              n_threads=2, inline_small=False,
                              interpret=True)
    text, sm, nr = st.align_chunk(pr, 0, n)
    assert text == ref
    assert (sm, nr) == (sm0, nr0)
    s = st.stats
    assert s["gap_banded"] > 0 and s["gap_fallback"] > 0, s
    assert s["gap_banded"] + s["gap_fallback"] == s["gap_problems"]
    assert s["gap_w32"] == s["gap_banded"]


def test_staged_pallas_refuses_cpu(env):
    """Without a GPU the pallas backend refuses to start rather than
    fall back to interpret mode or the CPU."""
    from yaha_tpu.config import AlignmentArgs
    from yaha_tpu.models.staged import StagedAligner
    genome, index = env
    with pytest.raises(RuntimeError, match="needs a GPU"):
        StagedAligner(AlignmentArgs(), genome, index, backend="pallas")


def test_cli_batch_pallas_without_gpu_exits(scratch):
    """--engine batch-pallas exits non-zero with a message when JAX's
    default backend is not a GPU; nothing runs on the CPU instead."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-pallas", "-osh", "no_gpu.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=600)
    assert r.returncode != 0
    assert b"needs a GPU" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "no_gpu.sam"))


def test_staged_cli_default_for_jax_engines(scratch):
    """--engine batch-xla rides the staged native frontend by default and
    reproduces the golden bytes (incl. header/cursor semantics)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "-osh", "A_staged.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "A_staged.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = f.read()

    def strip_pg(t):
        return b"\n".join(l for l in t.split(b"\n")
                          if not l.startswith(b"@PG"))
    assert strip_pg(mine) == strip_pg(gold)
    assert not os.path.exists(os.path.join(scratch, "A_staged.sam.cursor"))


def test_staged_qs_stats_match_native(scratch):
    """-qs through the staged engine: per-query id/len/seedMatches/
    alignments columns byte-match the native engine's TSV, and the usec
    column is a real per-read measurement (phases + per-problem DP time
    attributed inside the native pipeline, VERDICT r4 #7) — not a
    chunk-amortized constant."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for eng, qs in (("batch-xla", "qs_staged.tsv"),
                    ("native", "qs_native.tsv")):
        r = subprocess.run(
            [sys.executable, "-m", "yaha_tpu.cli", "-x",
             "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
             "--engine", eng, "-qs", qs, "-osh", "out_%s.sam" % eng],
            cwd=scratch, env=env, capture_output=True, timeout=1200)
        assert r.returncode == 0, r.stderr.decode()[-1500:]

    def cols(name):
        with open(os.path.join(scratch, name)) as f:
            return ["\t".join(line.split("\t")[:4]) for line in f]
    assert cols("qs_staged.tsv") == cols("qs_native.tsv")
    with open(os.path.join(scratch, "qs_staged.tsv")) as f:
        usec = [int(line.rstrip("\n").split("\t")[4])
                for line in f if not line.startswith("query\t")]
    # Per-read semantics: values vary across reads (an amortized column
    # would be constant) and are plausible per-read walls (< 1 s).
    assert len(set(usec)) > 1
    assert all(0 <= u < 1_000_000 for u in usec)


def test_staged_prewarm_compiles_and_exits(scratch):
    """--prewarm runs a compile-only sample pass and writes no output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--prewarm", "-osh", "prewarm.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"prewarm:" in r.stderr
    assert not os.path.exists(os.path.join(scratch, "prewarm.sam"))
