"""Ring-D strategy == unsharded, bitwise, on the 8-device CPU mesh.

parallel/ringd.py keeps the cost volume disparity-sharded through the
whole pyramid (halo-plane ppermute per level, ring argmax all-reduce,
psum backtracking); every configuration must reproduce the
single-device pipeline EXACTLY (SURVEY.md §7 hard part 2) — including
large-D geometries where every slab holds many top-level bins, D just
big enough that slabs hold ONE top bin each, and both LR modes.
"""

import dataclasses

import jax
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config, parallel
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import pipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.parallel import ringd


H, W = 96, 144


def make_batch(n_pairs, max_d, seed=0):
    pairs = []
    for i in range(n_pairs):
        rng = np.random.default_rng(seed + i)
        field = synthetic.block_disparity_field(H, W, max_d, rng, block=24)
        left, right, _ = synthetic.make_pair(H, W, field, seed=seed + i)
        pairs.append((left, right))
    return pairs


def unsharded_reference(pairs, cfg):
    outs = []
    for left, right in pairs:
        geom = cfg.geometry(H, W)
        lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
        rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
        outs.append(pipeline.match_padded(lp, rp, cfg, H, W))
    return {k: np.stack([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


def run_ringd(pairs, cfg, mesh):
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh,
                               "ringd")
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh,
                                "ringd")
    sharding = parallel.input_sharding(mesh, "ringd")
    lefts = jax.device_put(lefts, sharding)
    rights = jax.device_put(rights, sharding)
    return parallel.match_batch_sharded(lefts, rights, cfg, H, W, mesh,
                                        "ringd")


@pytest.mark.parametrize("lr_mode", ["flip", "direct"])
@pytest.mark.parametrize("max_d,n_slab,n_data", [
    (64, 4, 2),   # many bins per slab at every level
    (16, 4, 2),   # top level: exactly 1 bin per slab
    (48, 8, 1),   # D not a power of two -> padded bins in the last slab
])
def test_ringd_matches_unsharded(lr_mode, max_d, n_slab, n_data):
    cfg = Config(max_disparity=max_d, lr_mode=lr_mode, levels=2)
    mesh = parallel.make_mesh(n_data, n_slab)
    pairs = make_batch(2 * n_data, max_d)
    got = run_ringd(pairs, cfg, mesh)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(
            np.asarray(got[k]), want[k],
            err_msg=f"{lr_mode}/D={max_d}/K={n_slab}/{k}")


def test_ringd_no_lr_check():
    cfg = Config(max_disparity=32, lr_check=False, levels=2)
    mesh = parallel.make_mesh(1, 8)
    pairs = make_batch(2, 32, seed=5)
    got = run_ringd(pairs, cfg, mesh)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_ringd_large_d_kitti_class():
    """D=256 over 8 slabs — the geometry ringd exists for (BASELINE.md
    KITTI-large-D row); each slab's 32-bin volume pools locally with
    halo planes only."""
    global H, W
    h_saved, w_saved = H, W
    try:
        H, W = 48, 384
        cfg = Config(max_disparity=256, levels=2)
        mesh = parallel.make_mesh(1, 8)
        pairs = make_batch(1, 64, seed=13)  # true disparities stay small
        got = run_ringd(pairs, cfg, mesh)
        want = unsharded_reference(pairs, cfg)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    finally:
        H, W = h_saved, w_saved


def test_ringd_single_slab_degenerates():
    """K=1 must equal the unsharded pipeline (no collectives at all)."""
    cfg = Config(max_disparity=16, levels=2)
    mesh = parallel.make_mesh(2, 1)
    pairs = make_batch(2, 16, seed=9)
    got = run_ringd(pairs, cfg, mesh)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_ring_argmax_unit():
    """Ring (max, min-bin-tie) reduce == flat argmax, incl. exact ties."""
    from functools import partial
    from jax.sharding import PartitionSpec as P

    n = 8
    mesh = jax.make_mesh((n,), ("model",))
    rng = np.random.default_rng(0)
    # Values with deliberate exact ties across slabs; shard_map splits
    # the last axis into contiguous 16-bin slabs.
    vals = rng.choice(np.float32([0.1, 0.5, 0.5, 0.9]),
                      size=(4, 8, 16 * n))

    def body(v):  # (4, 8, 16) local slab
        ax = jax.lax.axis_index("model")
        k_loc = (np.int32(0) + jax.numpy.argmax(v, -1).astype(np.int32)
                 + ax * v.shape[-1])
        v_loc = jax.numpy.max(v, -1)
        _, k = ringd._ring_argmax(v_loc, k_loc, "model", n)
        return k

    got = jax.shard_map(body, mesh=mesh, in_specs=P(None, None, "model"),
                        out_specs=P(None, None), check_vma=False)(
        jax.numpy.asarray(vals))
    want = np.argmax(vals, axis=-1)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_ringd_four_slabs_d32_matches_unsharded():
    """D=32 over 4 slabs of 8 bins (two patch columns of shift each)
    == the unsharded pipeline, bitwise on every output."""
    cfg = Config(max_disparity=32, levels=2)
    mesh = parallel.make_mesh(1, 4)
    pairs = make_batch(2, 32, seed=21)
    got = run_ringd(pairs, cfg, mesh)
    want = unsharded_reference(pairs, cfg)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=f"ringd-d32/{k}")


def test_ringd_debug_checks_replication_invariant():
    """debug_checks=True adds the on-device replication assert
    (compensating for check_vma=False); a clean run must pass it."""
    from jax.experimental import checkify

    cfg = Config(max_disparity=16, levels=2)
    mesh = parallel.make_mesh(1, 4)
    pairs = make_batch(1, 16, seed=3)
    lefts = parallel.pad_batch([p[0] for p in pairs], cfg, H, W, mesh,
                               "ringd")
    rights = parallel.pad_batch([p[1] for p in pairs], cfg, H, W, mesh,
                                "ringd")
    sharding = parallel.input_sharding(mesh, "ringd")

    def run(lp, rp):
        return parallel.match_batch_sharded(lp, rp, cfg, H, W, mesh,
                                            "ringd", None, True)

    checked = checkify.checkify(run, errors=checkify.user_checks)
    err, out = checked(jax.device_put(lefts, sharding),
                       jax.device_put(rights, sharding))
    err.throw()  # clean run: invariant holds
    want = unsharded_reference(pairs, cfg)
    np.testing.assert_array_equal(np.asarray(out["disparity_raw"]),
                                  want["disparity_raw"])
