"""C13 post-filter parity, C14 io round-trips, C15 CLI smoke tests."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import Config
from deepmatching_stereo_matching_tpu.data import synthetic
from deepmatching_stereo_matching_tpu.io import writers
from deepmatching_stereo_matching_tpu.ops import postfilter as pf_dev
from deepmatching_stereo_matching_tpu.oracle import reference as oracle


def random_disparity_with_invalids(seed=0, h=37, w=53):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 32, size=(h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.25
    d[mask] = np.nan
    return d


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("fill", [False, True])
def test_postfilter_device_matches_oracle(k, fill):
    d = random_disparity_with_invalids()
    want = oracle.postfilter(d, k, fill)
    got = np.asarray(pf_dev.postfilter(jnp.asarray(d), k, fill))
    np.testing.assert_array_equal(got, want)


def test_postfilter_all_invalid_row():
    d = np.full((5, 7), np.nan, dtype=np.float32)
    d[0, 0] = 3.0
    want = oracle.postfilter(d, 3, True)
    got = np.asarray(pf_dev.postfilter(jnp.asarray(d), 3, True))
    np.testing.assert_array_equal(got, want)
    # Fully-invalid rows have no scanline fill source and stay invalid.
    assert np.isnan(want[4]).all()


def test_median_preserves_integers_and_removes_speckle():
    d = np.zeros((11, 11), dtype=np.float32) + 7.0
    d[5, 5] = 30.0  # speckle
    out = oracle.postfilter(d, 3, False)
    assert out[5, 5] == 7.0
    assert np.all(out == np.floor(out))


def test_pipeline_with_postfilter_matches_oracle():
    cfg = Config(max_disparity=16, median_filter=3, fill_invalid=True)
    rng = np.random.default_rng(5)
    field = synthetic.block_disparity_field(64, 96, 16, rng, block=16)
    left, right, _ = synthetic.make_pair(64, 96, field, seed=5)
    want = oracle.match_stereo(left, right, cfg)

    from deepmatching_stereo_matching_tpu import api

    got = api.match_stereo(left, right, cfg)
    np.testing.assert_array_equal(got.disparity, want.disparity)


# ---------------------------------------------------------------------------
# io round-trips
# ---------------------------------------------------------------------------


def test_pfm_roundtrip(tmp_path):
    d = random_disparity_with_invalids(seed=1)
    d_inf = np.nan_to_num(d, nan=np.inf, posinf=np.inf)
    path = str(tmp_path / "d.pfm")
    writers.write_pfm(path, d_inf)
    back = writers.read_pfm(path)
    np.testing.assert_array_equal(back, d_inf)


def test_png16_roundtrip(tmp_path):
    d = random_disparity_with_invalids(seed=2)
    path = str(tmp_path / "d.png")
    writers.write_disparity_png16(path, d)
    back = writers.read_disparity_png16(path)
    valid = np.isfinite(d) & (d > 0)
    np.testing.assert_allclose(back[valid], d[valid], atol=1 / 256)
    assert np.isnan(back[~np.isfinite(d)]).all()


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_stdlib_png_encoder_roundtrip(tmp_path, kind):
    """The compiler-free PNG fallback writes files a standard decoder
    reads back exactly."""
    from PIL import Image

    rng = np.random.default_rng(6)
    if kind == "gray8":
        img = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    elif kind == "rgb8":
        img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (9, 13), dtype=np.uint16)
    path = tmp_path / f"{kind}.png"
    path.write_bytes(writers.encode_png(img))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_colorize_shapes_and_invalid():
    d = random_disparity_with_invalids(seed=3)
    rgb = writers.colorize(d, vmax=32.0)
    assert rgb.shape == d.shape + (3,)
    assert rgb.dtype == np.uint8
    assert (rgb[~np.isfinite(d)] == 0).all()


def test_load_image_png(tmp_path):
    from deepmatching_stereo_matching_tpu.io import images

    arr = (np.random.default_rng(0).uniform(0, 255, (20, 30, 3))
           .astype(np.uint8))
    path = str(tmp_path / "im.png")
    writers._to_png(path, arr)
    back = images.load_image(path)
    np.testing.assert_array_equal(back, arr)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*argv):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "deepmatching_stereo_matching_tpu.cli",
         "--cpu", *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_demo_writes_outputs(tmp_path):
    out = str(tmp_path / "run")
    meta = run_cli("--demo", "--demo-size", "80", "120", "-D", "16",
                   "-o", out)
    assert meta["coverage"] > 0.3
    for name in ("disparity.pfm", "disparity_16bit.png",
                 "disparity_color.png", "valid.png", "metrics.json"):
        assert os.path.exists(os.path.join(out, name)), name


def test_cli_image_files_with_gt(tmp_path):
    rng = np.random.default_rng(9)
    field = synthetic.block_disparity_field(60, 90, 16, rng, block=16)
    left, right, gt = synthetic.make_pair(60, 90, field, seed=9)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    writers._to_png(lp, (left * 255).astype(np.uint8))
    writers._to_png(rp, (right * 255).astype(np.uint8))
    gtp = str(tmp_path / "gt.png")
    gtf = gt.astype(np.float32)
    gtf[gt < 0] = np.nan
    writers.write_disparity_png16(gtp, gtf)
    meta = run_cli(lp, rp, "-D", "16", "--gt", gtp)
    assert "bad_pixel_rate_kept" in meta
    assert meta["bad_pixel_rate_kept"] < 0.35  # 8-bit quantised inputs
