"""Two-process jax.distributed end-to-end: per-host read shards + merge.

Each process initializes the distributed runtime, aligns its
host_read_range shard of readsA, writes a part file, and host 0 merges —
the multi-host flow of parallel/distributed.py.  Output must be
byte-identical to the single-host golden (modulo the @PG path tokens,
which this test reproduces by using the golden file names).
"""
import gzip
import os
import shutil
import socket
import subprocess
import sys

import pytest

from conftest import DATA, GOLD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
pid = int(sys.argv[1])
port = sys.argv[2]
import jax
jax.distributed.initialize("127.0.0.1:" + port, num_processes=2,
                           process_id=pid)
sys.path.insert(0, "__REPO__")
from yaha_tpu.config import AlignmentArgs
from yaha_tpu.io import native_loader, sam
from yaha_tpu.native import host
from yaha_tpu.models.staged import StagedAligner
from yaha_tpu.parallel import distributed as dist

aa = AlignmentArgs()
aa.qfile_name = "readsA_100bp.fasta"
aa.xfile_name = "testgen.X11_01_65525S"
aa.ofile_name = "A_default.sam"
aa.post_process(True)
genome = native_loader.load_genome("testgen.nib2")
index = native_loader.load_index("testgen.X11_01_65525S")
aa.word_len = index.word_len
with open("readsA_100bp.fasta", "rb") as f:
    qdata = f.read()
aa.fastq = False
pr = host.parse_queries_native(qdata, False, aa.max_query_length,
                               aa.word_len)
lo, hi = dist.host_read_range(pr.n)
aligner = StagedAligner(aa, genome, index, backend="xla")
text, _, _ = aligner.align_chunk(pr, lo, hi)
with open(dist.part_file_name("out.sam"), "wb") as f:
    f.write(text)
# Barrier via a collective before host 0 merges.
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
mesh = Mesh(np.array(jax.devices()).reshape(2), ("data",))
total = jax.jit(shard_map(lambda x: jax.lax.psum(x.sum(), "data"),
                          mesh=mesh, in_specs=P("data"),
                          out_specs=P()))(np.ones(2))
assert float(total) == 2.0
if jax.process_index() == 0:
    dist.merge_part_files("out.sam", 2, sam.file_header(aa, genome))
print("worker", pid, "done", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed(tmp_path):
    for f in ("readsA_100bp.fasta",):
        shutil.copy(os.path.join(DATA, f), tmp_path)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(tmp_path, "testgen.X11_01_65525S"),
                  "wb") as out:
            out.write(f.read())
    worker = os.path.join(tmp_path, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER.replace("__REPO__", REPO))
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "worker.py", str(pid),
                               str(port)],
                              cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    with open(os.path.join(tmp_path, "out.sam"), "rb") as f:
        mine = f.read()
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = f.read()
    assert mine == gold


def test_multihost_cli_flags(tmp_path):
    """--coordinator/--num-hosts/--host-id through the staged engine:
    two CLI processes shard reads, write part files, and host 0 merges
    byte-identically (modulo the @PG file name) to the single-host
    golden."""
    import gzip
    for f in ("readsA_100bp.fasta",):
        shutil.copy(os.path.join(DATA, f), tmp_path)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(tmp_path, "testgen.X11_01_65525S"),
                  "wb") as out:
            out.write(f.read())
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--coordinator",
         "127.0.0.1:%d" % port,
         "--num-hosts", "2", "--host-id", str(pid), "-osh", "out.sam"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    with open(os.path.join(tmp_path, "out.sam"), "rb") as f:
        mine = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    assert mine == gold


def test_multihost_three_axis_compose(tmp_path):
    """All three parallel axes in ONE run (VERDICT r4 #3): two CLI hosts
    (reads range-sharded over hosts), each with 4 virtual devices
    arranged as a local (data=2 x model=2) mesh — the staged engine with
    the device seed phase over the hash-range ShardedIndex.  Output must
    be byte-identical (modulo @PG) to the single-host golden."""
    import gzip
    for f in ("readsA_100bp.fasta",):
        shutil.copy(os.path.join(DATA, f), tmp_path)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(tmp_path, "testgen.X11_01_65525S"),
                  "wb") as out:
            out.write(f.read())
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--seed", "device",
         "--model-shards", "2",
         "--coordinator", "127.0.0.1:%d" % port,
         "--num-hosts", "2", "--host-id", str(pid), "-osh", "out.sam"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    with open(os.path.join(tmp_path, "out.sam"), "rb") as f:
        mine = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    assert mine == gold


def test_multihost_cli_staged_seed_device(tmp_path):
    """The composed scale-out product path (round 4): two CLI hosts run
    the STAGED engine (--engine batch-xla default frontend) with the
    device seed phase (--seed device), range-shard reads, and host 0
    merges byte-identically to the single-host golden."""
    import gzip
    for f in ("readsA_100bp.fasta",):
        shutil.copy(os.path.join(DATA, f), tmp_path)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), tmp_path)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(tmp_path, "testgen.X11_01_65525S"),
                  "wb") as out:
            out.write(f.read())
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yaha_tpu.cli", "-x",
         "testgen.X11_01_65525S", "-q", "readsA_100bp.fasta",
         "--engine", "batch-xla", "--seed", "device",
         "--coordinator", "127.0.0.1:%d" % port,
         "--num-hosts", "2", "--host-id", str(pid), "-osh", "out.sam"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(2)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    with open(os.path.join(tmp_path, "out.sam"), "rb") as f:
        mine = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    with open(os.path.join(GOLD, "A_default.sam"), "rb") as f:
        gold = [l for l in f.read().splitlines()
                if not l.startswith(b"@PG")]
    assert mine == gold
