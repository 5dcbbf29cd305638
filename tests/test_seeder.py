"""Device seed phase for the staged engine (models/seeder.DeviceSeeder).

The composed product x scale-out path (round-4 headline): the seed scan
+ SO/ROA lookup + (diag, qo) sort run on the accelerator — sharded over
a (data x model) mesh against the hash-range ShardedIndex, or on one
device with the index replicated — and the hit rows feed the native
staged chaining (yt_hits_to_clumps), byte-identical to the host seed
scan.  Covers the parity edges that live in the seed phase:

  * phantom-hit quirk rows (QueryMatch.c:57-69): device wrapped-run
    flags + exact host injection, merged in sorted position;
  * capacity-tier overflow: compacted big-tier retry, and top-tier
    overflow falling back to the host scan for that strand;
  * the CLI surface: --seed device and --model-shards N.
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
    d = tmp_path_factory.mktemp("seeder")
    for f in ("readsA_100bp.fasta", "readsC_1kb.fasta",
              "readsD_sv.fasta", "readsE_150bp.fastq"):
        shutil.copy(os.path.join(DATA, f), d)
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


def _make_aa(qfile, **over):
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
    # readsC at tight params: exercises phantom rows AND a top-tier
    # overflow fallback (seeder handles both, asserted below).
    ("readsC_1kb.fasta", {"band_width": 3, "max_gap": 20, "min_match": 15,
                          "x_cutoff": 15}),
    ("readsD_sv.fasta", {"fbs": True}),
    ("readsE_150bp.fastq", {}),
]


@pytest.mark.parametrize("qfile,over", CONFIGS,
                         ids=["params1kb", "sv_fbs", "fastq"])
def test_device_seeder_single_device_parity(scratch, env, qfile, over):
    from yaha_tpu.models.seeder import DeviceSeeder
    from yaha_tpu.models.staged import StagedAligner
    genome, index = env
    aa = _make_aa(qfile, **over)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    base = StagedAligner(aa, genome, index, backend="native", n_threads=2)
    ref, _, _ = base.align_chunk(pr, 0, pr.n)
    seeder = DeviceSeeder(aa, index)
    st = StagedAligner(aa, genome, index, backend="native", n_threads=2,
                       seeder=seeder)
    text, _, _ = st.align_chunk(pr, 0, pr.n)
    assert text == ref, (qfile, over)
    if qfile == "readsC_1kb.fasta":
        # the seed-phase parity edges actually ran
        assert seeder.stats["phantom_rows"] > 0
        assert seeder.stats["cap_retries"] > 0
        assert seeder.stats["fallback_rows"] > 0


def test_device_seeder_mesh_parity(scratch, env):
    """Sharded-index seed phase on a (data=4, model=2) virtual mesh,
    feeding the SAME staged native pipeline — byte parity incl. phantom
    rows, with the big tier wide enough that nothing falls back."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from yaha_tpu.models.seeder import DeviceSeeder
    from yaha_tpu.models.staged import StagedAligner
    try:
        cpus = jax.devices("cpu")
    except RuntimeError:                    # pragma: no cover
        cpus = []
    if len(cpus) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    genome, index = env
    aa = _make_aa("readsC_1kb.fasta", band_width=3, max_gap=20,
                  min_match=15, x_cutoff=15)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    pr = _parsed(scratch, aa)
    base = StagedAligner(aa, genome, index, backend="native", n_threads=2)
    ref, _, _ = base.align_chunk(pr, 0, pr.n)
    mesh = Mesh(np.array(cpus[:8]).reshape(4, 2), ("data", "model"))
    seeder = DeviceSeeder(aa, index, mesh=mesh, n_model=2)
    st = StagedAligner(aa, genome, index, backend="native", n_threads=2,
                       seeder=seeder)
    text, _, _ = st.align_chunk(pr, 0, pr.n)
    assert text == ref
    assert seeder.stats["phantom_rows"] > 0
    assert seeder.stats["all_gather_bytes"] > 0


def test_cli_seed_device(scratch):
    """--seed device on the staged jax engine reproduces the golden."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--seed", "device",
         "-osh", "A_seeddev.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "A_seeddev.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = f.read()

    def strip_pg(t):
        return b"\n".join(l for l in t.split(b"\n")
                          if not l.startswith(b"@PG"))
    assert strip_pg(mine) == strip_pg(gold)


def test_cli_model_shards(scratch):
    """--model-shards 2: the sharded-index seed phase through the CLI on
    the 8-vdev mesh, byte-identical to the golden."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    xf = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xf:
        env["XLA_FLAGS"] = (
            xf + " --xla_force_host_platform_device_count=8").strip()
    r = subprocess.run(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--model-shards", "2",
         "-osh", "A_shards.sam"],
        cwd=scratch, env=env, capture_output=True, timeout=1200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    with open(os.path.join(scratch, "A_shards.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = f.read()

    def strip_pg(t):
        return b"\n".join(l for l in t.split(b"\n")
                          if not l.startswith(b"@PG"))
    assert strip_pg(mine) == strip_pg(gold)
