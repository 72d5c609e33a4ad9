"""W-tiled / 2-D-tiled sharding == unsharded, bitwise (SURVEY.md §4.4).

The halo-exchange spatial strategy (parallel/wtiled.py) must reproduce
the single-device pipeline exactly on the 8-device virtual CPU mesh:
ppermute halos, the mirror-flip, the coarse-level all_gather merge, and
the cross-tile LR gather all preserve bit-identity (SURVEY.md §7 hard
parts 2/3).
"""

import jax
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import pipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu import parallel
from deepmatching_stereo_matching_tpu.parallel import wtiled

H, W, D = 96, 144, 16


def make_batch(n_pairs, seed=0):
    pairs = []
    for i in range(n_pairs):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, D, rng, block=24)
        left, right, gt = synthetic.make_pair(H, W, field, seed=seed + i)
        pairs.append((left, right))
    return pairs


def unsharded_reference(pairs, cfg, hp, wp):
    """Single-device outputs at the SAME padded extents as the tiles.

    The 2-D tile grid may pad H/W further than the single-device
    geometry would; extra zero rows/columns yield zero descriptors and
    never change the cropped result, so match_padded on the tile-padded
    arrays is the bitwise target.
    """
    outs = []
    for left, right in pairs:
        g = oracle.to_grayscale_f32(left)
        lp = np.zeros((hp, wp), np.float32)
        lp[: g.shape[0], : g.shape[1]] = g
        g = oracle.to_grayscale_f32(right)
        rp = np.zeros((hp, wp), np.float32)
        rp[: g.shape[0], : g.shape[1]] = g
        outs.append(pipeline.match_padded(lp, rp, cfg, H, W))
    return {k: np.stack([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


def run_wtiled(pairs, cfg, mesh, merge_level=None):
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh,
                               "wtiled", merge_level)
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh,
                                "wtiled", merge_level)
    sharding = parallel.input_sharding(mesh, "wtiled")
    lefts = jax.device_put(lefts, sharding)
    rights = jax.device_put(rights, sharding)
    got = parallel.match_batch_sharded(lefts, rights, cfg, H, W, mesh,
                                       "wtiled", merge_level)
    return got, lefts.shape[1], lefts.shape[2]


def assert_matches(pairs, cfg, mesh, merge_level=None):
    got, hp, wp = run_wtiled(pairs, cfg, mesh, merge_level)
    want = unsharded_reference(pairs, cfg, hp, wp)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]), want[k], err_msg=k)


@pytest.mark.parametrize("lr_mode", ["flip", "direct"])
@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
def test_wtiles_match_unsharded(lr_mode, descriptor):
    """Pure W-tiling (4 tiles), full tile-local pyramid (l0 == L)."""
    cfg = Config(max_disparity=D, lr_mode=lr_mode, descriptor=descriptor)
    mesh = parallel.make_mesh2d(2, 1, 4)
    assert_matches(make_batch(4), cfg, mesh)


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
def test_2d_tiles_match_unsharded(descriptor):
    """H x W 2-D tile grid (2 x 2), incl. the grad_hist row halo."""
    cfg = Config(max_disparity=D, lr_mode="direct", descriptor=descriptor)
    mesh = parallel.make_mesh2d(2, 2, 2)
    assert_matches(make_batch(2), cfg, mesh)


@pytest.mark.parametrize("merge_level", [0, 1])
@pytest.mark.parametrize("lr_mode", ["flip", "direct"])
def test_coarse_merge_matches_unsharded(merge_level, lr_mode):
    """Tiles aligned only to 2**l0 < 2**L: all_gather pyramid merge."""
    cfg = Config(max_disparity=D, lr_mode=lr_mode)
    mesh = parallel.make_mesh2d(1, 1, 8)
    glob, local, l0 = wtiled.tiled2d_geometry(Config(max_disparity=D),
                                              H, W, 1, 8, merge_level)
    assert l0 == merge_level  # below L, so the merge path really runs
    assert_matches(make_batch(2, seed=5), cfg, mesh, merge_level)


def test_no_lr_check_wtiled():
    cfg = Config(max_disparity=D, lr_check=False, descriptor="grad_hist")
    mesh = parallel.make_mesh2d(1, 1, 8)
    assert_matches(make_batch(2, seed=7), cfg, mesh, 1)


def test_tile_too_narrow_raises():
    cfg = Config(max_disparity=256)
    mesh = parallel.make_mesh2d(1, 1, 8)
    pairs = make_batch(1)
    with pytest.raises(ValueError, match="halo"):
        run_wtiled(pairs, cfg, mesh)
