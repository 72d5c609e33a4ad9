"""tools/eval_dataset.py: layout discovery + end-to-end evaluation."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import eval_dataset  # noqa: E402

from deepmatching_stereo_matching_tpu.data.synthetic import make_block_pair
from deepmatching_stereo_matching_tpu.io import writers


def _write(tmp, layout):
    left, right, gt = make_block_pair(64, 96, max_disparity=16, seed=3)
    u8 = lambda a: np.clip(a * 255.0, 0, 255).astype(np.uint8)  # noqa
    if layout == "flat":
        writers._to_png(str(tmp / "a_left.png"), u8(left))
        writers._to_png(str(tmp / "a_right.png"), u8(right))
        writers.write_pfm(str(tmp / "a_gt.pfm"), gt.astype(np.float32))
    elif layout == "mb":
        d = tmp / "scene"
        d.mkdir()
        writers._to_png(str(d / "im2.png"), u8(left))
        writers._to_png(str(d / "im6.png"), u8(right))
        writers.write_pfm(str(d / "disp2.pfm"), gt.astype(np.float32))
    else:  # kitti
        for sub in ("image_2", "image_3", "disp_occ_0"):
            (tmp / sub).mkdir()
        writers._to_png(str(tmp / "image_2" / "000000_10.png"), u8(left))
        writers._to_png(str(tmp / "image_3" / "000000_10.png"), u8(right))
        writers.write_disparity_png16(
            str(tmp / "disp_occ_0" / "000000_10.png"),
            gt.astype(np.float32))


@pytest.mark.parametrize("layout", ["flat", "mb", "kitti"])
def test_discovery(tmp_path, layout):
    _write(tmp_path, layout)
    found = eval_dataset.discover(str(tmp_path), 1.0)
    assert len(found) == 1
    name, lp, rp, gtp, scale = found[0]
    assert os.path.exists(lp) and os.path.exists(rp)
    assert gtp is not None and os.path.exists(gtp)


def test_end_to_end_cli(tmp_path):
    _write(tmp_path, "flat")
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "eval_dataset.py"),
         str(tmp_path), "-D", "16", "--cpu",
         "--oracle-check", "1", "--out", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip())
    assert summary["pairs"] == 1 and summary["with_gt"] == 1
    report = json.load(open(out))
    row = report["pairs"][0]
    assert row["bad_pixel_rate_kept"] <= 0.02
    assert row["oracle_decision_disagreement"] == 0.0
