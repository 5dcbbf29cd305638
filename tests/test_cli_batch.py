"""Engine CLI: parity, checkpoint cursor, and resume (native + staged)."""
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
    d = tmp_path_factory.mktemp("clibatch")
    shutil.copy(os.path.join(DATA, "readsA_100bp.fasta"), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(d, "testgen.X11_01_65525S"), "wb") as out:
            out.write(f.read())
    return d


def _run(scratch, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", *args],
        cwd=scratch, env=env, capture_output=True, timeout=1200)


def test_native_engine_parity_and_no_cursor(scratch):
    r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
             "readsA_100bp.fasta", "--engine", "native", "-osh",
             "A_default.sam")
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "A_default.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        assert mine == f.read()
    assert not os.path.exists(os.path.join(scratch,
                                           "A_default.sam.cursor"))


def test_removed_engines_rejected(scratch):
    """--engine batch / batch-numpy were removed (VERDICT r4 #6); the
    CLI must reject them with a pointer to the surviving engines."""
    for eng in ("batch", "batch-numpy"):
        r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
                 "readsA_100bp.fasta", "--engine", eng, "-osh", "x.sam")
        assert r.returncode != 0
        assert b"removed" in r.stderr
    r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
             "readsA_100bp.fasta", "--engine", "batch-xla",
             "--frontend", "device", "-osh", "x.sam")
    assert r.returncode != 0
    assert b"removed" in r.stderr


def test_engine_resume(scratch):
    # Full reference output first.
    r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
             "readsA_100bp.fasta", "--engine", "native", "-osh",
             "full.sam")
    assert r.returncode == 0

    # Simulate preemption: emit only the first 120 reads in-process
    # (header + partial output + cursor), then resume via the CLI.
    sys.path.insert(0, REPO)
    from yaha_tpu.config import AlignmentArgs
    from yaha_tpu.io import native_loader, sam
    from yaha_tpu.native import host
    genome = native_loader.load_genome(
        os.path.join(scratch, "testgen.nib2"))
    index = native_loader.load_index(
        os.path.join(scratch, "testgen.X11_01_65525S"))
    aa = AlignmentArgs()
    aa.qfile_name = "readsA_100bp.fasta"
    aa.xfile_name = "testgen.X11_01_65525S"
    aa.ofile_name = "part.sam"
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.fastq = False
    with open(os.path.join(scratch, "readsA_100bp.fasta"), "rb") as f:
        qdata = f.read()
    pr = host.parse_queries_native(qdata, False, aa.max_query_length,
                                   aa.word_len)
    text, _, _, _ = host.align_batch_native(pr, 0, 120, genome, index,
                                            aa, n_threads=1)
    with open(os.path.join(scratch, "part.sam"), "wb") as out:
        out.write(sam.file_header(aa, genome).encode("latin-1"))
        out.write(text)
    with open(os.path.join(scratch, "part.sam.cursor"), "w") as f:
        f.write("120")

    r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
             "readsA_100bp.fasta", "--engine", "native", "--batch-size",
             "40", "--resume", "-osh", "part.sam")
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    assert b"Resuming at read 120" in r.stderr
    with open(os.path.join(scratch, "part.sam")) as f:
        resumed = f.read()
    with open(os.path.join(scratch, "full.sam")) as f:
        full = f.read()
    # Identical apart from the @PG output-file token.
    assert (resumed.replace("part.sam", "full.sam") == full)
    assert not os.path.exists(os.path.join(scratch, "part.sam.cursor"))


def test_long_read_cap_lift(tmp_path):
    """--max-query-length aligns a read beyond the reference's 32 kb cap
    through the native engine (CP-analog, SURVEY.md section 5)."""
    import gzip
    import shutil
    import subprocess
    import sys
    import os
    from conftest import DATA, GOLD
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(tmp_path, "testgen.X11_01_65525S"),
                  "wb") as out:
            out.write(f.read())
    sys.path.insert(0, os.path.join(repo, "tools"))
    import random
    import make_testdata as mt
    rng = random.Random(20260816)
    genome = mt.make_genome(rng)
    read = genome["chr1"][:40000]
    with open(os.path.join(tmp_path, "long.fasta"), "w") as f:
        f.write(">long1\n%s\n" % read)
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "long.fasta", "--engine",
         "native", "--max-query-length", "64000", "-osh", "long.sam"],
        cwd=tmp_path, env=env, capture_output=True, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-1000:]
    with open(os.path.join(tmp_path, "long.sam")) as f:
        recs = [l for l in f if not l.startswith("@")]
    assert recs and recs[0].split("\t")[5] == "40000M"


def test_native_grouper_fallback_parity(scratch):
    """Reads whose strand hit count exceeds YT_SORT_HITS_CAP route to the
    streaming diag-hash grouper instead of the hit radix sort
    (yaha_host.cpp yt_seed_to_clumps); forcing the cap to 0 must still
    reproduce the golden byte-for-byte."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["YT_SORT_HITS_CAP"] = "0"
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "native", "-osh", "fallback.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "fallback.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        golden = f.read()
    strip = lambda b: b"\n".join(
        l for l in b.split(b"\n") if not l.startswith(b"@PG"))
    assert strip(mine) == strip(golden)


def test_native_verbose_stats_report(scratch):
    """-v prints the per-run STATS distributions (Query.c:519-536 analog):
    query count, length min/max/avg, per-strand total-count min/max/avg,
    non-aligned count, alignments-per-query min/max."""
    r = _run(scratch, "-x", "testgen.X11_01_65525S", "-q",
             "readsA_100bp.fasta", "--engine", "native", "-v",
             "--batch-size", "64", "-osh", "vstats.sam")
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    err = r.stderr.decode()
    assert "200 queries processed." in err
    assert "Query Lengths vary from 100 to 100 with average 100." in err
    # Per-strand totals: min over non-zero strands, avg over 2*queries.
    assert "Total Counts vary from" in err
    assert "There were 0 queries with no Alignment." in err
    assert "Total Alignments Output = 200, average 1.00 per non-zero " \
           "query." in err
    assert "the min number of alignments was 1." in err
    assert "The max number of alignments per query was 1." in err


XLA_SWEEP = [
    ("A_fbs.sam", "readsA_100bp.fasta", ["-FBS", "Y", "-osh"]),
    ("A_all.sam", "readsA_100bp.fasta", ["-OQC", "N", "-osh"]),
    ("A_edit.sam", "readsA_100bp.fasta", ["-AGS", "N", "-osh"]),
    ("E_fastq.sam", "readsE_150bp.fastq", ["-osh"]),
    ("D_default.sam", "readsD_sv.fasta", ["-osh"]),
    ("C_params.sam", "readsC_1kb.fasta",
     ["-BW", "3", "-G", "20", "-M", "15", "-X", "15", "-osh"]),
]


@pytest.mark.parametrize("out_name,reads,args", XLA_SWEEP,
                         ids=["xla-" + c[0] for c in XLA_SWEEP])
def test_batch_xla_engine_parity_sweep(scratch, out_name, reads, args):
    """The staged engine's XLA DP twins across modes that exercise
    distinct post-DP policies (FBS, ALL-mode dups, edit-distance, FASTQ
    quals, SV splits, custom band/scoring); byte parity modulo @PG."""
    shutil.copy(os.path.join(DATA, reads), scratch)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    out_path = "xla_" + out_name
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", reads,
         "--engine", "batch-xla", *args, out_path],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, out_path), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, out_name), "rb") as f:
        golden = f.read()
    strip = lambda b: b"\n".join(
        l for l in b.split(b"\n") if not l.startswith(b"@PG"))
    assert strip(mine) == strip(golden)


def test_device_engine_threaded_pipeline_parity(scratch):
    """-t N on the device engines pipelines batches through host threads
    sharing the one device (PP-analog, cli.py tpool); output must be
    byte-identical to the sequential run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "-t", "3", "--batch-size", "32", "--engine", "batch-xla",
         "-osh", "tpipe.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "tpipe.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        golden = f.read()
    strip = lambda b: b"\n".join(
        l for l in b.split(b"\n") if not l.startswith(b"@PG"))
    assert strip(mine) == strip(golden)
