"""Sharded == unsharded, bitwise, on an 8-device virtual CPU mesh.

SURVEY.md §4.4: distributed behaviour is validated without a cluster via
xla_force_host_platform_device_count (set in conftest.py).  Every
strategy must reproduce the single-device pipeline exactly — the
bit-comparability-under-sharding requirement (SURVEY.md §7 hard part 2).
"""

import jax
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import pipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu import parallel


H, W, D = 96, 144, 16


def make_batch(n_pairs, seed=0):
    pairs = []
    for i in range(n_pairs):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, D, rng, block=24)
        left, right, gt = synthetic.make_pair(H, W, field, seed=seed + i)
        pairs.append((left, right))
    return pairs


def unsharded_reference(pairs, cfg):
    """Per-pair single-device pipeline outputs, stacked."""
    outs = []
    for left, right in pairs:
        geom = cfg.geometry(H, W)
        lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
        rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
        outs.append(pipeline.match_padded(lp, rp, cfg, H, W))
    return {k: np.stack([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


@pytest.mark.parametrize("strategy", ["tiled", "dslab"])
@pytest.mark.parametrize("lr_mode", ["flip", "direct"])
def test_sharded_matches_unsharded(strategy, lr_mode):
    cfg = Config(max_disparity=D, lr_mode=lr_mode)
    mesh = parallel.make_mesh(2, 4)
    pairs = make_batch(4)
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh,
                               strategy)
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh,
                                strategy)
    sharding = parallel.input_sharding(mesh, strategy)
    lefts = jax.device_put(lefts, sharding)
    rights = jax.device_put(rights, sharding)
    got = parallel.match_batch_sharded(lefts, rights, cfg, H, W, mesh,
                                       strategy)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]), want[k], err_msg=f"{strategy}/{lr_mode}/{k}")


def test_no_lr_check_sharded():
    cfg = Config(max_disparity=D, lr_check=False)
    mesh = parallel.make_mesh(1, 8)
    pairs = make_batch(2, seed=7)
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh)
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh)
    got = parallel.match_batch_sharded(lefts, rights, cfg, H, W, mesh,
                                       "tiled")
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_quality_on_sharded_run():
    """Sharded pipeline recovers synthetic ground truth like any other."""
    cfg = Config(max_disparity=D)
    mesh = parallel.make_mesh(2, 4)
    rng = np.random.default_rng(3)
    field = synthetic.block_disparity_field(H, W, D, rng, block=24)
    left, right, gt = synthetic.make_pair(H, W, field, seed=3)
    lefts = parallel.pad_batch([left] * 2, cfg, H, W, mesh)
    rights = parallel.pad_batch([right] * 2, cfg, H, W, mesh)
    got = parallel.match_batch_sharded(lefts, rights, cfg, H, W, mesh,
                                       "tiled")
    from deepmatching_stereo_matching_tpu.utils import metrics
    rate = metrics.bad_pixel_rate(np.asarray(got["disparity"][0]), gt,
                                  count_invalid=False)
    # Sanity only (bitwise equality above is the real sharding check):
    # kept-pixel accuracy on this occlusion-heavy synthetic scene.
    assert rate < 0.15


@pytest.mark.parametrize("strategy,n_data,n_model,max_d,levels,seed", [
    ("tiled", 2, 4, D, None, 3),
    ("dslab", 2, 2, D, None, 31),
    # 8 bins over 4 slabs: each slab (2 bins) is narrower than a patch.
    ("dslab", 1, 4, 8, 1, 41),
])
def test_sharded_mesh_shapes_match_unsharded(strategy, n_data, n_model,
                                             max_d, levels, seed):
    """Other mesh shapes and slab widths == the unsharded pipeline,
    bitwise, on every output."""
    cfg = Config(max_disparity=max_d, levels=levels)
    mesh = parallel.make_mesh(n_data, n_model)
    pairs = make_batch(2 * n_data, seed=seed)
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh,
                               strategy)
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh,
                                strategy)
    sharding = parallel.input_sharding(mesh, strategy)
    got = parallel.match_batch_sharded(
        jax.device_put(lefts, sharding), jax.device_put(rights, sharding),
        cfg, H, W, mesh, strategy)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=f"{strategy}/{k}")
