"""Adversarial synthetic scenes.

data/synthetic.py:adversarial_pair builds the regimes the LR
consistency check and post-filter exist for — occlusion bands at
foreground boundaries, textureless surfaces, photometric asymmetry
between the eyes — with EXACT ground truth and an exact occlusion
mask.  These tests pin (a) oracle<->device parity on hostile scenes,
(b) that the LR check actually rejects occluded pixels, and (c) that
kept non-occluded pixels stay accurate despite bias/noise asymmetry.
Thresholds carry slack over measured values (occ rejection 0.49-0.85,
kept-bad 0.10-0.12 on seeds 0-2 at 120x180 D=32).
"""

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.models import pipeline
from deepmatching_stereo_matching_tpu.oracle import reference as oracle

H, W, D = 120, 180, 32


def run_device(left, right, cfg):
    geom = cfg.geometry(H, W)
    lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
    rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
    return {k: np.asarray(v) for k, v in
            pipeline.match_padded(lp, rp, cfg, H, W).items()}


def test_occlusion_mask_exact():
    """Hand-built field: a d=8 foreground box over a d=0 background
    occludes exactly the 8 background columns left of its left edge."""
    field = np.zeros((4, 32), dtype=np.int32)
    field[:, 16:24] = 8
    occ = synthetic.occlusion_mask(field)
    want = np.zeros((4, 32), dtype=bool)
    want[:, 8:16] = True  # src x-0 == src of x+8 - 8 for x in [8,16)
    np.testing.assert_array_equal(occ, want)


def test_oracle_parity_on_adversarial_scene():
    """Bitwise oracle parity must hold on hostile scenes too."""
    left, right, gt, occ = synthetic.adversarial_pair(H, W, D, seed=0)
    cfg = Config(max_disparity=D)
    got = run_device(left, right, cfg)
    want = oracle.match_stereo(left, right, cfg)
    np.testing.assert_array_equal(got["disparity_raw"], want.disparity_raw)
    np.testing.assert_array_equal(got["valid"], want.valid)
    np.testing.assert_array_equal(got["disparity"], want.disparity)


def test_lr_check_rejects_occlusions():
    occ_total = rej_total = 0
    bad = kept = 0
    for seed in range(3):
        left, right, gt, occ = synthetic.adversarial_pair(H, W, D,
                                                          seed=seed)
        out = run_device(left, right, Config(max_disparity=D))
        valid = out["valid"]
        occ_total += occ.sum()
        rej_total += (~valid[occ]).sum()
        keep = valid & ~occ & (gt >= 0)
        kept += keep.sum()
        bad += (np.abs(out["disparity"][keep] - gt[keep]) > 1).sum()
    assert rej_total / occ_total > 0.4, "LR check rejects occlusions"
    assert bad / kept < 0.2, "kept non-occluded pixels stay accurate"


def test_lr_check_is_the_rejector():
    """Without the LR check nothing rejects occlusions (coverage 1.0),
    demonstrating the mechanism under test is the one doing the work."""
    left, right, gt, occ = synthetic.adversarial_pair(H, W, D, seed=0)
    out = run_device(left, right, Config(max_disparity=D, lr_check=False))
    assert out["valid"].all()


def test_textureless_region_outputs_finite():
    """A fully textureless pair must not produce NaN/inf scores; the
    smallest-d tie rule makes the all-equal correlations pick d=0."""
    left = np.full((64, 96), 0.5, dtype=np.float32)
    right = np.full((64, 96), 0.5, dtype=np.float32)
    out = run_device_small(left, right, Config(max_disparity=16))
    assert np.isfinite(out["score"]).all()
    assert (out["disparity_raw"] == 0).all()


def run_device_small(left, right, cfg):
    h, w = left.shape
    geom = cfg.geometry(h, w)
    lp = oracle.pad_image(oracle.to_grayscale_f32(left), geom)
    rp = oracle.pad_image(oracle.to_grayscale_f32(right), geom)
    return {k: np.asarray(v) for k, v in
            pipeline.match_padded(lp, rp, cfg, h, w).items()}
