"""bf16 compute mode: quality within the bad-pixel bound (SURVEY.md §7.5).

bf16 halves cost-volume/pyramid HBM traffic but can flip near-tie argmax
winners, so it is NOT bit-compared to the oracle; instead the disparity
decisions must stay within the bad-pixel error bound on scenes the f32
pipeline solves exactly.
"""

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config, api
from deepmatching_stereo_matching_tpu.data.synthetic import make_block_pair
from deepmatching_stereo_matching_tpu.utils.metrics import bad_pixel_rate


@pytest.mark.parametrize("descriptor,lr_mode", [
    ("patch", "flip"), ("grad_hist", "flip"), ("patch", "direct")])
def test_bf16_quality_within_bound(descriptor, lr_mode):
    cfg16 = Config(max_disparity=24, dtype="bfloat16",
                   descriptor=descriptor, lr_mode=lr_mode)
    left, right, gt = make_block_pair(96, 144, max_disparity=24, seed=4)
    res = api.match_stereo(left, right, cfg16)
    assert res.disparity.dtype == np.float32  # outputs stay f32
    rate = bad_pixel_rate(res.disparity, gt, count_invalid=False)
    assert rate < 0.05, rate


def test_bf16_close_to_f32_decisions():
    cfg32 = Config(max_disparity=24)
    cfg16 = Config(max_disparity=24, dtype="bfloat16")
    left, right, _ = make_block_pair(96, 144, max_disparity=24, seed=8)
    r32 = api.match_stereo(left, right, cfg32)
    r16 = api.match_stereo(left, right, cfg16)
    both = r32.valid & r16.valid
    agree = np.mean(
        r32.disparity_raw[both] == r16.disparity_raw[both])
    assert agree > 0.98, agree
