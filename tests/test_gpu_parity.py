"""On-GPU parity for the staged engine (`gpu` marker; skipped without a
GPU).

Run on a machine with an NVIDIA GPU: python -m pytest -m gpu tests/
(chip_smoke.py runs them as its first card phase).  Whether a GPU is
present is decided inside the module fixture, by asking a child
process.  All device work runs in ONE child process with JAX's default
platform (one process per card, and each kernel tier compiles once):
it stages the golden inputs, calls the CLI's main() for each golden
configuration, checks both compiled kernels against the native DP, and
prints one marker per passed check.  The test process itself stays on
the CPU (tests/conftest.py).
"""
import gzip
import os
import shutil
import subprocess
import sys

import pytest

from conftest import DATA, GOLD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu

GOLDEN_RUNS = {
    "A_default.sam": ("readsA_100bp.fasta", []),
    "F_edge.sam": ("readsF_edge.fasta", ["--seed", "device"]),
    "C_params.sam": ("readsC_1kb.fasta",
                     ["-BW", "3", "-G", "20", "-M", "15", "-X", "15"]),
}

CHILD = r"""
import sys
from yaha_tpu import cli
runs = %(runs)r
gold = %(gold)r
for out, (reads, extra) in runs.items():
    rc = cli.main(["-x", "testgen.X11_01_65525S", "-q", reads,
                   "--engine", "batch-pallas", *extra, "-osh", out])
    assert rc in (0, None), (out, rc)
    with open(out, "rb") as f, open(gold + "/" + out, "rb") as g:
        if f.read() == g.read():
            print("GOLDEN_OK", out, flush=True)
%(kernels)s
print("KERNELS_OK")
"""

KERNELS = r"""
import numpy as np
from yaha_tpu.ops import dp_common, sw_pallas
from yaha_tpu.native import host

rng = np.random.default_rng(31)
KW = dict(go=5, ge=2, rc=3, ms=1, max_gap=50, max_intron=50)
n, ql, rl = 1000, 24, 32
q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
r = rng.integers(0, 4, (n, rl)).astype(np.uint8)
qlens = rng.integers(4, ql + 1, n).astype(np.int64)
rlens = rng.integers(4, rl + 1, n).astype(np.int64)
lbw = np.maximum(1, qlens - 1)
rbw = np.maximum(1, rlens - 1)
ref = host.anchored_forward(q, qlens, r, rlens, lbw, rbw, **KW)
wband = int((lbw + rbw).max()) + 1
band = sw_pallas.anchored_forward_pallas_banded(
    q, qlens, r, rlens, lbw, rbw, wband=wband, **KW)
assert np.array_equal(np.asarray(band["score"]), ref["score"])
bt_b = np.asarray(sw_pallas.problem_major(band["bt_b"]))
for k in range(0, n, 37):
    want = dp_common.traceback_anchored(ref["eo"][k], ref["idc"][k],
                                        int(qlens[k]), int(rlens[k]))
    assert dp_common.traceback_anchored_banded_packed(
        bt_b[k], int(lbw[k]), int(qlens[k]), int(rlens[k])) == want, k

ext_kw = dict(band_width=5, x_cutoff=25, **KW)
rx = np.concatenate([q, rng.integers(0, 4, (n, 20)).astype(np.uint8)], 1)
rx[rng.random(rx.shape) < 0.1] = 0
rlx = np.minimum(qlens + 10, ql + 20)
ref = host.extension_forward(q, qlens, rx, rlx, **ext_kw)
out = sw_pallas.extension_forward_pallas(q, qlens, rx, rlx, **ext_kw)
for key in ("score", "maxi", "maxj"):
    assert np.array_equal(np.asarray(out[key]), ref[key]), key
bt = np.asarray(sw_pallas.problem_major(out["bt"]))
for k in range(0, n, 37):
    want = dp_common.traceback_extension(
        ref["eo"][k], ref["idc"][k], int(ref["maxi"][k]),
        int(ref["maxj"][k]), int(ref["score"][k]), 10, False)
    assert dp_common.traceback_extension_packed(
        bt[k], int(ref["maxi"][k]), int(ref["maxj"][k]),
        int(ref["score"][k]), 10, False) == want, k
"""


def _gpu_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    return env


@pytest.fixture(scope="module")
def gpu_out(tmp_path_factory):
    """stdout of the one child that runs every device check."""
    env = _gpu_env()
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0 or r.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("no GPU")
    d = tmp_path_factory.mktemp("gpu")
    for reads, _ in GOLDEN_RUNS.values():
        shutil.copy(os.path.join(DATA, reads), d)
    shutil.copy(os.path.join(GOLD, "testgen.nib2"), d)
    with gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")) as f:
        with open(os.path.join(d, "testgen.X11_01_65525S"), "wb") as out:
            out.write(f.read())
    script = CHILD % {"runs": GOLDEN_RUNS, "gold": GOLD,
                      "kernels": KERNELS}
    r = subprocess.run([sys.executable, "-c", script], cwd=d, env=env,
                       capture_output=True, text=True, timeout=1200)
    return r.stdout + "\nRC=%d\n" % r.returncode + r.stderr[-3000:]


def test_batch_pallas_on_gpu_golden(gpu_out):
    """--engine batch-pallas (compiled Pallas DP kernels + device RLE
    decode) reproduces the golden SAM bytes."""
    assert "GOLDEN_OK A_default.sam" in gpu_out, gpu_out[-3000:]


def test_seed_device_on_gpu_golden(gpu_out):
    """--seed device (k-mer scan + SO/ROA lookup + hit sort on the GPU)
    composed with the staged engine reproduces the golden bytes."""
    assert "GOLDEN_OK F_edge.sam" in gpu_out, gpu_out[-3000:]


def test_long_reads_on_gpu_golden(gpu_out):
    """1 kb reads with non-default DP parameters (narrower band, shorter
    X-drop) through the compiled kernels."""
    assert "GOLDEN_OK C_params.sam" in gpu_out, gpu_out[-3000:]


def test_kernels_on_gpu_match_native(gpu_out):
    """Both compiled kernels bit-identical to the native host DP,
    including the packed backtrack decode (integer DP: exact)."""
    assert "KERNELS_OK" in gpu_out, gpu_out[-3000:]
