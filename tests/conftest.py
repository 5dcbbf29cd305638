import os
import sys

# Force CPU + an 8-device virtual mesh for sharding tests before JAX import.
# Tests that need a GPU (the `gpu` marker) run their device work in child
# processes with an environment of their own.
os.environ["JAX_PLATFORMS"] = "cpu"
xf = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xf:
    os.environ["XLA_FLAGS"] = (
        xf + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Build the native host library on first use (gitignored binary).
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "yaha_tpu", "native", "libyaha_host.so")
_SRCS = [os.path.join(_REPO, "yaha_tpu", "native", f)
         for f in ("yaha_host.cpp", "yaha_pipe.cpp", "yaha_index.cpp")]
if (not os.path.exists(_SO) or
        os.path.getmtime(_SO) < max(os.path.getmtime(s) for s in _SRCS)):
    import subprocess
    subprocess.run(["bash", os.path.join(_REPO, "tools", "build_native.sh")],
                   capture_output=True)

import gzip
import pytest
import numpy as np

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="session")
def genome():
    from yaha_tpu.io import nib2
    with open(os.path.join(GOLD, "testgen.nib2"), "rb") as f:
        return nib2.load(f.read())


@pytest.fixture(scope="session")
def test_index():
    """The standard L11 test index, loaded from the committed golden."""
    from yaha_tpu.io.index_io import Index
    raw = gzip.open(os.path.join(GOLD, "testgen.X11_01_65525S.gz")).read()
    data = np.frombuffer(raw, dtype=np.uint32)
    word_len = int(data[1])
    ht_size = 1 << (2 * word_len)
    return Index(word_len=word_len, max_hits=int(data[2]),
                 total_matches=int(data[3]),
                 starting_offs=data[4:4 + ht_size + 1],
                 roa=data[4 + ht_size + 1:])


def data_path(name):
    return os.path.join(DATA, name)


def gold_path(name):
    return os.path.join(GOLD, name)
