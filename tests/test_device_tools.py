"""Device-facing tooling: GPU-only entry scripts, compile cache, timing.

`chip_smoke.py` and `bench.py` measure the GPU and must refuse to run
anywhere else; the compile cache must land where
JAX_COMPILATION_CACHE_DIR says, else in the git-ignored <repo>/.jax_cache;
`utils/timing.steady_state` must only ever report positive samples.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from deepmatching_stereo_matching_tpu.utils import compile_cache, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd, env_extra=None, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("script,alone", [
    ("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False)])
def test_gpu_scripts_refuse_the_cpu(tmp_path, script, alone):
    """Off the GPU — or with nothing of the repo beside it — the script
    exits nonzero and prints no result line."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, script), tmp_path)
        cwd = str(tmp_path)
    proc = _run([script], cwd)
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout
    assert '"value"' not in proc.stdout


_PROBE = """
import sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from deepmatching_stereo_matching_tpu.utils.compile_cache import (
    enable_compile_cache)
path = enable_compile_cache()
if {compile}:
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: x * 3 + 1)(jnp.ones(5)).block_until_ready()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_uses_env_dir(tmp_path):
    cache = tmp_path / "xla_cache"
    proc = _run(["-c", _PROBE.format(repo=REPO, compile=True)],
                str(tmp_path),
                {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(cache), str(cache)]
    assert any(n.endswith("-cache") for n in os.listdir(cache))


def test_compile_cache_defaults_to_ignored_repo_dir():
    path = os.path.join(REPO, ".jax_cache")
    assert compile_cache.REPO_CACHE == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    # No compile: the location alone is checked, nothing is cached.
    proc = _run(["-c", _PROBE.format(repo=REPO, compile=False)], REPO,
                drop=("JAX_COMPILATION_CACHE_DIR",))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [path, path]


def test_steady_state_samples_are_positive():
    f = jax.jit(lambda x: jnp.cumsum(jnp.sin(x), axis=0))
    x = jnp.ones((64, 64))
    st = timing.steady_state(f, (x,), repeats=4, iters=3)
    assert len(st["samples"]) == 4 and st["iters"] == 3
    assert all(s > 0 for s in st["samples"])
    assert st["min"] <= st["median"] <= st["max"]


def test_steady_state_rejects_non_positive_sample(monkeypatch):
    """A frozen clock yields a zero-length sample: an error, not a
    result."""
    monkeypatch.setattr(timing.time, "perf_counter", lambda: 1.0)
    with pytest.raises(RuntimeError, match="non-positive"):
        timing.steady_state(jax.jit(lambda x: x + 1), (jnp.ones(3),))
