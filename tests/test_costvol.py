"""Level-0 cost volume (ops/costvol.py) vs plain references.

Forward and reverse directions, halo-extended targets (origin_offset),
disparity padding (max_disparity < D0), traced disparity-slab offsets,
edge columns whose targets run out of range, and degenerate inputs.
The references are the NumPy oracle (oracle/reference.py:cost_volume)
and, where the oracle has no such argument, an explicit loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu.ops import costvol
from deepmatching_stereo_matching_tpu.oracle import reference as oracle


def rand_desc(rng, h0, w, c):
    d = rng.standard_normal((h0, w, c)).astype(np.float32)
    return d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)


def loop_reference(src, tgt, d0, p, max_d, reverse=False, origin_offset=0):
    """C0[i, j, d] by explicit loops over (j, d) — no vectorised gather."""
    h0, w0, _ = src.shape
    wt = tgt.shape[1]
    out = np.zeros((h0, w0, d0), np.float32)
    for j in range(w0):
        for d in range(d0):
            x = p * j + p * origin_offset + (d if reverse else -d)
            if 0 <= x < wt and d < max_d:
                out[:, j, d] = np.maximum(
                    np.sum(src[:, j] * tgt[:, x], axis=-1), 0.0)
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("d0,max_d", [(16, 16), (16, 13), (8, 1)])
def test_matches_oracle(reverse, d0, max_d):
    rng = np.random.default_rng(0)
    h0, w0, p, c = 5, 12, 4, 16
    src = rand_desc(rng, h0, w0, c)
    tgt = rand_desc(rng, h0, w0 * p, c)
    want = oracle.cost_volume(src, tgt, d0, p, max_d, reverse=reverse)
    got = np.asarray(costvol.cost_volume(jnp.asarray(src), jnp.asarray(tgt),
                                         d0, p, max_d, reverse=reverse))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Padding bins are exactly zero.
    assert not got[:, :, max_d:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("origin_offset", [1, 3])
def test_halo_extended_targets(reverse, origin_offset):
    """Target array extended left by origin_offset patch columns."""
    rng = np.random.default_rng(1)
    h0, w0, p, c, d0 = 3, 8, 4, 8, 8
    src = rand_desc(rng, h0, w0, c)
    wt = p * (w0 + origin_offset) + p  # halo left + one extra col right
    tgt = rand_desc(rng, h0, wt, c)
    want = loop_reference(src, tgt, d0, p, d0, reverse=reverse,
                          origin_offset=origin_offset)
    got = costvol.cost_volume(jnp.asarray(src), jnp.asarray(tgt), d0, p, d0,
                              reverse=reverse, origin_offset=origin_offset)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)


def test_halo_equals_unsharded_slice():
    """A W-tile with a left halo reproduces the global volume's columns
    (the halo-extension contract of SURVEY.md §5.7)."""
    rng = np.random.default_rng(2)
    h0, w0, p, c, d0 = 3, 16, 4, 8, 8
    src = jnp.asarray(rand_desc(rng, h0, w0, c))
    tgt = jnp.asarray(rand_desc(rng, h0, w0 * p, c))
    full = np.asarray(costvol.cost_volume(src, tgt, d0, p, d0))

    tile = slice(8, 16)            # right half of the patch columns
    halo_cols = d0 // p + (1 if d0 % p else 0)  # patch cols of halo
    src_t = src[:, tile]
    tgt_lo = p * (tile.start - halo_cols)
    tgt_t = tgt[:, tgt_lo: p * tile.stop]
    got = np.asarray(costvol.cost_volume(src_t, tgt_t, d0, p, d0,
                                         origin_offset=halo_cols))
    np.testing.assert_array_equal(got, full[:, tile])


def test_zero_descriptors_score_zero():
    h0, w0, p, c, d0 = 2, 6, 4, 8, 4
    src = jnp.zeros((h0, w0, c), jnp.float32)
    tgt = jnp.zeros((h0, w0 * p, c), jnp.float32)
    got = np.asarray(costvol.cost_volume(src, tgt, d0, p, d0))
    assert not got.any()


def test_out_of_range_targets_masked():
    """Column j with d > p*j must be zero (target left of the image)."""
    rng = np.random.default_rng(3)
    h0, w0, p, c, d0 = 2, 4, 4, 8, 16
    src = jnp.asarray(rand_desc(rng, h0, w0, c))
    tgt = jnp.asarray(np.abs(rand_desc(rng, h0, w0 * p, c)))
    got = np.asarray(costvol.cost_volume(src, tgt, d0, p, d0))
    for j in range(w0):
        assert not got[:, j, p * j + 1:].any()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("d_off", [0, 8, 16])
def test_traced_slab_offset_matches_oracle_slice(reverse, d_off):
    """A disparity slab [d_off, d_off + 8) with a TRACED d_offset (as
    the sharded strategies pass it) == that slice of the oracle's
    full-range volume."""
    rng = np.random.default_rng(7)
    h0, w0, c, p, max_d, dl = 8, 24, 16, 4, 24, 8
    src = rand_desc(rng, h0, w0, c)
    tgt = rand_desc(rng, h0, w0 * p, c)
    full = oracle.cost_volume(src, tgt, max_d, p, max_d, reverse=reverse)
    slab = jax.jit(functools.partial(
        costvol.cost_volume, disparities=dl, patch_size=p,
        max_disparity=max_d, reverse=reverse))
    got = np.asarray(slab(jnp.asarray(src), jnp.asarray(tgt),
                          d_offset=jnp.int32(d_off)))
    np.testing.assert_allclose(got, full[:, :, d_off: d_off + dl],
                               atol=1e-6)
