"""The persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
when set (and then nothing else is configured), else one fixed,
gitignored directory at the root of the checkout."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = ("from yaha_tpu import cli; cli.setup_compile_cache(); import jax; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(jax.config.jax_persistent_cache_min_compile_time_secs)")


def _probe(env_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", PROBE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_dir_choice(monkeypatch, tmp_path, from_env):
    from yaha_tpu import cli
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cli.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert cli.compile_cache_dir() == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_setup_compile_cache(tmp_path, from_env):
    """setup_compile_cache() leaves an environment-chosen cache alone
    (JAX reads the variable itself, with its own defaults) and otherwise
    points JAX at the checkout's fixed directory."""
    if from_env:
        cache_dir, min_secs = _probe(str(tmp_path / "c"))
        assert cache_dir == str(tmp_path / "c")
        assert float(min_secs) == 1.0   # JAX's default, untouched
    else:
        cache_dir, min_secs = _probe(None)
        assert cache_dir == os.path.join(REPO, ".jax_cache")
        assert float(min_secs) == 0.0
