"""Sanitizer mode (SURVEY.md §5.2): input validation + checkify guards."""

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config, api
from deepmatching_stereo_matching_tpu.data.synthetic import make_block_pair
from deepmatching_stereo_matching_tpu.utils import checks


def test_validate_rejects_bad_inputs():
    good = np.zeros((16, 24), dtype=np.uint8)
    with pytest.raises(ValueError, match="shapes differ"):
        checks.validate_images(good, np.zeros((16, 25), dtype=np.uint8))
    with pytest.raises(ValueError, match="must be"):
        checks.validate_images(np.zeros((4,)), good)
    with pytest.raises(ValueError, match="channels"):
        checks.validate_images(np.zeros((8, 8, 2)), np.zeros((8, 8, 2)))
    with pytest.raises(ValueError, match="empty"):
        checks.validate_images(np.zeros((0, 8)), np.zeros((0, 8)))
    with pytest.raises(ValueError, match="NaN"):
        bad = np.full((8, 8), np.nan, dtype=np.float32)
        checks.validate_images(bad, bad)


def test_debug_checks_pass_on_valid_pair():
    left, right, gt = make_block_pair(48, 64, max_disparity=8, seed=0)
    cfg = Config(max_disparity=8, levels=2)
    res = api.match_stereo(left, right, cfg, debug_checks=True)
    base = api.match_stereo(left, right, cfg)
    np.testing.assert_array_equal(res.disparity_raw, base.disparity_raw)
    np.testing.assert_array_equal(res.valid, base.valid)


def test_checked_pipeline_catches_nonfinite_padded_input():
    import jax.numpy as jnp
    from jax.experimental import checkify

    cfg = Config(max_disparity=8, levels=2)
    geom = cfg.geometry(48, 64)
    lp = np.zeros((geom.padded_height, geom.padded_width), np.float32)
    rp = lp.copy()
    lp[3, 5] = np.inf  # slipped past the host boundary somehow
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite"):
        checks.checked_match_padded(jnp.asarray(lp), jnp.asarray(rp),
                                    cfg, 48, 64)
