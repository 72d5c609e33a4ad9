"""Golden tests: jitted device pipeline vs the NumPy oracle (SURVEY.md §4.3).

The oracle is the semantic definition; the jitted pipeline must reproduce
its integer disparity decisions.  Float intermediates may differ by ULPs
(XLA vs NumPy reduction order in dot products and x**1.4), so integer
outputs are compared with a tiny mismatch budget for near-ties, and float
intermediates with tight tolerances (SURVEY.md §7 hard part 2).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.api import match_stereo, preprocess
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.data.synthetic import make_block_pair
from deepmatching_stereo_matching_tpu.models import descriptors, pipeline
from deepmatching_stereo_matching_tpu.ops import costvol as costvol_ops
from deepmatching_stereo_matching_tpu.ops import pool as pool_ops
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.utils.metrics import bad_pixel_rate


def _padded_pair(h=96, w=128, d=24, seed=11, cfg=None, **pair_kw):
    cfg = cfg or Config(max_disparity=d, levels=3)
    left, right, gt = make_block_pair(h, w, max_disparity=d, seed=seed,
                                      **pair_kw)
    lp = preprocess(left, cfg, h, w)
    rp = preprocess(right, cfg, h, w)
    return cfg, left, right, gt, lp, rp


class TestStages:
    def test_left_descriptors_match(self):
        cfg, *_, lp, rp = _padded_pair()
        ours = np.asarray(jax.jit(descriptors.left_descriptors,
            static_argnums=1)(jnp.asarray(lp), cfg))
        ref = oracle.left_descriptors(lp, cfg)
        np.testing.assert_allclose(ours, ref, atol=1e-6)

    def test_right_sliding_descriptors_match(self):
        cfg, *_, lp, rp = _padded_pair()
        ours = np.asarray(jax.jit(descriptors.right_sliding_descriptors,
            static_argnums=1)(jnp.asarray(rp), cfg))
        ref = oracle.right_sliding_descriptors(rp, cfg)
        np.testing.assert_allclose(ours, ref, atol=1e-6)

    def test_grad_hist_descriptors_match(self):
        cfg = Config(max_disparity=16, levels=2, descriptor="grad_hist")
        _, _, _, _, lp, rp = _padded_pair(64, 96, 16, cfg=cfg)
        ours = np.asarray(jax.jit(descriptors.left_descriptors,
            static_argnums=1)(jnp.asarray(lp), cfg))
        ref = oracle.left_descriptors(lp, cfg)
        np.testing.assert_allclose(ours, ref, atol=1e-5)
        ours_r = np.asarray(jax.jit(descriptors.right_sliding_descriptors,
            static_argnums=1)(jnp.asarray(rp), cfg))
        ref_r = oracle.right_sliding_descriptors(rp, cfg)
        np.testing.assert_allclose(ours_r, ref_r, atol=1e-5)

    def test_cost_volume_matches(self):
        cfg, *_, lp, rp = _padded_pair()
        geom = cfg.geometry(96, 128)
        dl = oracle.left_descriptors(lp, cfg)
        dr = oracle.right_sliding_descriptors(rp, cfg)
        ref = oracle.cost_volume(dl, dr, geom.disparities, cfg.patch_size,
                                 cfg.max_disparity)
        ours = np.asarray(jax.jit(functools.partial(
            costvol_ops.cost_volume, disparities=geom.disparities,
            patch_size=cfg.patch_size, max_disparity=cfg.max_disparity))(
            jnp.asarray(dl), jnp.asarray(dr)))
        np.testing.assert_allclose(ours, ref, atol=1e-6)

    def test_pool3_subsample_matches(self):
        rng = np.random.default_rng(0)
        m = rng.uniform(0, 1, size=(8, 12, 16)).astype(np.float32)
        sub_r, arg_r = oracle.pool3_subsample(m)
        sub_j, arg_j = jax.jit(pool_ops.pool3_subsample)(jnp.asarray(m))
        np.testing.assert_array_equal(np.asarray(sub_j), sub_r)
        np.testing.assert_array_equal(np.asarray(arg_j), arg_r)

    def test_pool3_subsample_matches_with_ties(self):
        rng = np.random.default_rng(1)
        # Quantised values force many exact ties.
        m = (rng.integers(0, 4, size=(6, 6, 16)) / 4.0).astype(np.float32)
        sub_r, arg_r = oracle.pool3_subsample(m)
        sub_j, arg_j = jax.jit(pool_ops.pool3_subsample)(jnp.asarray(m))
        np.testing.assert_array_equal(np.asarray(sub_j), sub_r)
        np.testing.assert_array_equal(np.asarray(arg_j), arg_r)

    def test_aggregate_children_matches(self):
        rng = np.random.default_rng(2)
        s = rng.uniform(0, 1, size=(8, 12, 8)).astype(np.float32)
        ref = oracle.aggregate_children(s, 1.4)
        ours = np.asarray(jax.jit(pool_ops.aggregate_children,
            static_argnums=1)(jnp.asarray(s), 1.4))
        # x**1.4: XLA and NumPy pow differ by a few ULPs
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)

    def test_backtrack_matches(self):
        cfg, *_, lp, rp = _padded_pair()
        geom = cfg.geometry(96, 128)
        dl = oracle.left_descriptors(lp, cfg)
        dr = oracle.right_sliding_descriptors(rp, cfg)
        c0 = oracle.cost_volume(dl, dr, geom.disparities, cfg.patch_size,
                                cfg.max_disparity)
        maps_r, args_r = oracle.build_pyramid(c0, geom.levels, cfg.lam)
        k_r, s_r = oracle.backtrack(maps_r, args_r)
        # Feed the same float maps to the device backtracker: exact match.
        k_j, s_j = jax.jit(pipeline.backtrack)(
            [jnp.asarray(m) for m in maps_r],
            [jnp.asarray(a) for a in args_r])
        np.testing.assert_array_equal(np.asarray(k_j), k_r)
        np.testing.assert_array_equal(np.asarray(s_j), s_r)


class TestEndToEnd:
    @pytest.mark.parametrize("desc", ["patch", "grad_hist"])
    def test_matches_oracle(self, desc):
        cfg = Config(max_disparity=24, levels=3, descriptor=desc)
        left, right, gt = make_block_pair(96, 128, max_disparity=24, seed=11)
        res_j = match_stereo(left, right, cfg)
        res_o = oracle.match_stereo(left, right, cfg)
        agree = np.mean(res_j.disparity_raw == res_o.disparity_raw)
        assert agree > 0.999, agree  # ULP near-tie budget
        valid_agree = np.mean(res_j.valid == res_o.valid)
        assert valid_agree > 0.998, valid_agree
        assert abs(bad_pixel_rate(res_j.disparity, gt)
                   - bad_pixel_rate(res_o.disparity, gt)) < 0.005

    def test_no_lr_check(self):
        cfg = Config(max_disparity=16, levels=2, lr_check=False)
        left, right, gt = make_block_pair(64, 96, max_disparity=16, seed=13)
        res_j = match_stereo(left, right, cfg)
        res_o = oracle.match_stereo(left, right, cfg)
        assert np.mean(res_j.disparity_raw == res_o.disparity_raw) > 0.999
        assert res_j.disparity_right is None
        assert res_j.valid.all()

    def test_non_divisible_shapes(self):
        # 100x150 needs padding at every level; outputs crop back exactly.
        cfg = Config(max_disparity=20, levels=3)
        left, right, gt = make_block_pair(100, 150, max_disparity=20, seed=17)
        res_j = match_stereo(left, right, cfg)
        res_o = oracle.match_stereo(left, right, cfg)
        assert res_j.disparity.shape == (100, 150)
        assert np.mean(res_j.disparity_raw == res_o.disparity_raw) > 0.999

    def test_quality_on_synthetic(self):
        cfg = Config(max_disparity=24, levels=3)
        left, right, gt = make_block_pair(96, 128, max_disparity=24, seed=19)
        res = match_stereo(left, right, cfg)
        assert bad_pixel_rate(res.disparity, gt, count_invalid=False) < 0.02


class TestLRConsistencyPatch:
    """Patch-level LR check == pixel-level check on densified maps."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("d0,tau", [(16, 1.0), (32, 0.0), (8, 2.0)])
    def test_matches_pixel_formulation(self, seed, d0, tau):
        rng = np.random.default_rng(seed)
        h0, w0, p = 7, 19, 4
        dl = rng.integers(0, d0, size=(h0, w0)).astype(np.int32)
        dr = rng.integers(0, d0, size=(h0, w0)).astype(np.int32)
        dl_px = np.repeat(np.repeat(dl, p, 0), p, 1)
        dr_px = np.repeat(np.repeat(dr, p, 0), p, 1)
        want = np.asarray(jax.jit(
            lambda a, b: pipeline.lr_consistency(a, b, tau, d0)
        )(jnp.asarray(dl_px), jnp.asarray(dr_px)))
        got = np.asarray(jax.jit(
            lambda a, b: pipeline.lr_consistency_patch(a, b, tau, d0, p)
        )(jnp.asarray(dl), jnp.asarray(dr)))
        np.testing.assert_array_equal(got, want)

    def test_boundary_disparities(self):
        """dL values at the extremes: 0 and D0-1 everywhere."""
        h0, w0, p, d0 = 3, 9, 4, 16
        for val in (0, d0 - 1):
            dl = np.full((h0, w0), val, dtype=np.int32)
            dr = np.full((h0, w0), val, dtype=np.int32)
            dl_px = np.repeat(np.repeat(dl, p, 0), p, 1)
            dr_px = np.repeat(np.repeat(dr, p, 0), p, 1)
            want = np.asarray(pipeline.lr_consistency(
                jnp.asarray(dl_px), jnp.asarray(dr_px), 1.0, d0))
            got = np.asarray(pipeline.lr_consistency_patch(
                jnp.asarray(dl), jnp.asarray(dr), 1.0, d0, p))
            np.testing.assert_array_equal(got, want)


def test_match_padded_core_large_serial_bitwise():
    """large=True (sequential lax.map over directions, the large-D
    path) is bitwise-identical to the vmapped core."""
    import jax.numpy as jnp
    from deepmatching_stereo_matching_tpu.data import synthetic
    from deepmatching_stereo_matching_tpu.oracle import reference as oracle

    h, w, d = 64, 96, 16
    cfg = Config(max_disparity=d, levels=2)
    geom = cfg.geometry(h, w)
    rng = np.random.default_rng(2)
    field = synthetic.block_disparity_field(h, w, d, rng, block=16)
    left, right, _ = synthetic.make_pair(h, w, field, seed=2)
    lp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left), geom))
    rp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right), geom))
    a = pipeline.match_padded_core(lp, rp, cfg, geom, large=True)
    b = pipeline.match_padded_core(lp, rp, cfg, geom)
    for k in a:
        if k == "score":
            # XLA fuses the scan-mapped descriptor normalisation
            # differently than the vmapped one; decisions are the
            # bitwise contract, scores agree to float rounding.
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def test_match_dmajor_xla_bitwise():
    """D-major XLA pyramid+backtrack (the large-D fallback) is
    bit-identical to the canonical (H, W, D) build_pyramid+backtrack."""
    rng = np.random.default_rng(5)
    for d, h0, w0, levels in [(32, 16, 24, 2), (96, 8, 16, 3)]:
        vol = np.maximum(
            rng.standard_normal((h0, w0, d)).astype("f4"), 0.0)
        maps, args = pipeline.build_pyramid(jnp.asarray(vol), levels, 1.4)
        wk, ws = pipeline.backtrack(maps, args)
        gk, gs = pipeline.match_dmajor_xla(
            jnp.moveaxis(jnp.asarray(vol), -1, 0), levels, 1.4)
        np.testing.assert_array_equal(np.asarray(gk), np.asarray(wk))
        np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))


class TestDmajorPoolOps:
    """D-major pool/merge variants == the canonical (H, W, D) forms
    (transposed layouts, identical values — the large-D path's ops)."""

    def test_pool3_subsample_dmajor_matches(self):
        rng = np.random.default_rng(4)
        m = rng.uniform(0, 1, size=(8, 12, 16)).astype(np.float32)
        sub, arg = pool_ops.pool3_subsample(jnp.asarray(m))
        sub_d, arg_d = pool_ops.pool3_subsample_dmajor(
            jnp.moveaxis(jnp.asarray(m), -1, 0))
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(sub_d), 0, -1), np.asarray(sub))
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(arg_d), 0, -1), np.asarray(arg))

    def test_pool3_subsample_dmajor_lo_pad(self):
        rng = np.random.default_rng(5)
        m = rng.uniform(0, 1, size=(8, 12, 16)).astype(np.float32)
        halo = rng.uniform(0, 1, size=(8, 12)).astype(np.float32)
        sub, arg = pool_ops.pool3_subsample(jnp.asarray(m),
                                            lo_pad=jnp.asarray(halo))
        sub_d, arg_d = pool_ops.pool3_subsample_dmajor(
            jnp.moveaxis(jnp.asarray(m), -1, 0), lo_pad=jnp.asarray(halo))
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(sub_d), 0, -1), np.asarray(sub))
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(arg_d), 0, -1), np.asarray(arg))

    def test_aggregate_children_dmajor_matches(self):
        rng = np.random.default_rng(6)
        s = rng.uniform(0, 1, size=(8, 12, 8)).astype(np.float32)
        want = pool_ops.aggregate_children(jnp.asarray(s), 1.4)
        got = pool_ops.aggregate_children_dmajor(
            jnp.moveaxis(jnp.asarray(s), -1, 0), 1.4)
        np.testing.assert_array_equal(
            np.moveaxis(np.asarray(got), 0, -1), np.asarray(want))


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
def test_extra_zero_width_padding_is_result_invariant(descriptor):
    """Extra zero padding (whole quadtree blocks) beyond a width that is
    already padded must not change any cropped output: padding columns
    are zero descriptors that score exactly 0 (the oracle's out-of-range
    rule), in BOTH matching directions (the flip direction sees them as
    left-side zeros, same as the out-of-image halo).  The image already
    has padding columns here (150 -> 160), which grad_hist needs: its
    gradient at the last image column is one-sided only when no padding
    column follows it."""
    import dataclasses

    h, w, max_d = 64, 150, 16
    cfg = Config(max_disparity=max_d, levels=2, descriptor=descriptor)
    geom = cfg.geometry(h, w)
    assert geom.padded_width > w
    wider = dataclasses.replace(
        geom, padded_width=geom.padded_width + 64,
        grid_w=(geom.padded_width + 64) // cfg.patch_size)
    left, right, _ = synthetic.make_pair(
        h, w, synthetic.block_disparity_field(
            h, w, max_d, np.random.default_rng(4), block=16), seed=4)
    outs = []
    for g in (geom, wider):
        lp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(left),
                                          g))
        rp = jnp.asarray(oracle.pad_image(oracle.to_grayscale_f32(right),
                                          g))
        core = pipeline.match_padded_core(lp, rp, cfg, g)
        outs.append({k: np.asarray(v)
                     for k, v in pipeline.crop(core, h, w).items()})
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k],
                                      err_msg=f"padding changed {k}")


def _noise_pair(rng, hp, wp):
    left = rng.standard_normal((hp, wp)).astype(np.float32) * 0.3 + 0.5
    right = rng.standard_normal((hp, wp)).astype(np.float32) * 0.3 + 0.5
    return left, right


def _oracle_one_direction(left, right, cfg, geom):
    dl = oracle.left_descriptors(left, cfg)
    dr = oracle.right_sliding_descriptors(right, cfg)
    cost = oracle.cost_volume(dl, dr, geom.disparities, cfg.patch_size,
                              cfg.max_disparity)
    return oracle.backtrack(*oracle.build_pyramid(cost, geom.levels,
                                                  cfg.lam))


@pytest.mark.parametrize("descriptor", ["patch", "grad_hist"])
@pytest.mark.parametrize("h0,w0,max_d,levels", [
    (8, 16, 16, 2),       # single quadtree block row
    (16, 16, 16, 2),      # two block rows
    (16, 24, 13, 2),      # padding bins d >= max_disparity
    (32, 48, 32, 3),      # deeper pyramid
])
def test_one_direction_matches_oracle(h0, w0, max_d, levels, descriptor):
    """Image -> (disparity, score) on noise images: decisions exactly the
    oracle's, scores to f32 rounding."""
    rng = np.random.default_rng(h0 + w0 + max_d)
    p = 4
    cfg = Config(max_disparity=max_d, levels=levels, descriptor=descriptor)
    geom = cfg.geometry(h0 * p, w0 * p)
    left, right = _noise_pair(rng, h0 * p, w0 * p)
    want_d, want_s = _oracle_one_direction(left, right, cfg, geom)
    got_d, got_s = jax.jit(pipeline.one_direction, static_argnums=(2, 3))(
        jnp.asarray(left), jnp.asarray(right), cfg, geom)
    np.testing.assert_array_equal(np.asarray(got_d), want_d)
    np.testing.assert_allclose(np.asarray(got_s), want_s, atol=2e-6)


def test_left_edge_out_of_range_scores_zero():
    """Patches whose chosen disparity reaches left of the image score
    exactly 0 (the oracle's zero rule), and decisions match it."""
    rng = np.random.default_rng(7)
    p, h0, w0, max_d, levels = 4, 8, 8, 16, 2
    cfg = Config(max_disparity=max_d, levels=levels)
    geom = cfg.geometry(h0 * p, w0 * p)
    left, right = _noise_pair(rng, h0 * p, w0 * p)
    got_d, got_s = pipeline.one_direction(jnp.asarray(left),
                                          jnp.asarray(right), cfg, geom)
    got_d, got_s = np.asarray(got_d), np.asarray(got_s)
    want_d, _ = _oracle_one_direction(left, right, cfg, geom)
    np.testing.assert_array_equal(got_d, want_d)
    cols = np.arange(w0)[None, :] * p
    assert not got_s[got_d > cols].any()
