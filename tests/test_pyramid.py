"""Pyramid + backtracking vs the NumPy oracle (SURVEY.md §4.2, §3.4).

Both layouts of the device pyramid — D-minor `build_pyramid` +
`backtrack` and D-major `match_dmajor_xla` (the dslab strategy's) —
must reproduce oracle.build_pyramid + oracle.backtrack: same pool pad,
tie orders, summation order and first-max argmax, including on
tie-heavy, all-zero and constant-row volumes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu.models import pipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle


def _random(levels, h0, w0, d0, seed):
    rng = np.random.default_rng(seed)
    return np.maximum(rng.standard_normal((h0, w0, d0)),
                      0.0).astype(np.float32), levels


def _volume(kind):
    if kind.startswith("random"):
        levels, h0, w0, d0 = {
            "random-l1": (1, 2, 2, 2), "random-l2": (2, 4, 8, 8),
            "random-l3": (3, 8, 16, 16), "random-l4": (4, 16, 32, 64),
            "random-d128": (2, 16, 16, 128)}[kind]
        return _random(levels, h0, w0, d0, seed=levels + d0)
    if kind == "tie-heavy":
        rng = np.random.default_rng(7)
        return rng.integers(0, 3, size=(8, 16, 16)).astype(
            np.float32) * 0.5, 3
    if kind == "all-zero":
        return np.zeros((4, 8, 8), np.float32), 2
    if kind == "constant-rows":
        return np.broadcast_to(np.linspace(0, 1, 16, dtype=np.float32),
                               (8, 16, 16)).copy(), 3
    raise ValueError(kind)


KINDS = ["random-l1", "random-l2", "random-l3", "random-l4", "random-d128",
         "tie-heavy", "all-zero", "constant-rows"]


@pytest.mark.parametrize("layout", ["dminor", "dmajor"])
@pytest.mark.parametrize("kind", KINDS)
def test_matches_oracle(kind, layout):
    cost, levels = _volume(kind)
    want_k, want_s = oracle.backtrack(*oracle.build_pyramid(cost, levels,
                                                            1.4))
    if layout == "dminor":
        maps, args = pipeline.build_pyramid(jnp.asarray(cost), levels, 1.4)
        got_k, got_s = pipeline.backtrack(maps, args)
    else:
        got_k, got_s = pipeline.match_dmajor_xla(
            jnp.moveaxis(jnp.asarray(cost), -1, 0), levels, 1.4)
    np.testing.assert_array_equal(np.asarray(got_k), want_k)
    np.testing.assert_array_equal(np.asarray(got_s), want_s)
    if kind == "all-zero":
        assert not np.asarray(got_k).any()


def test_bf16_layouts_agree():
    """bf16 volumes: the D-major and D-minor layouts select identically
    (same ops in the same order, transposed)."""
    cost, levels = _random(3, 8, 16, 16, seed=3)
    cost_bf = jnp.asarray(cost, jnp.bfloat16)
    wk, ws = pipeline.backtrack(*pipeline.build_pyramid(cost_bf, levels,
                                                        1.4))
    gk, gs = pipeline.match_dmajor_xla(jnp.moveaxis(cost_bf, -1, 0),
                                       levels, 1.4)
    np.testing.assert_array_equal(np.asarray(gk), np.asarray(wk))
    np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))
