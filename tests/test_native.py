"""Native C++ IO runtime: codec parity, loader semantics, PNG validity.

The native layer (deepmatching_stereo_matching_tpu/native) must be a
drop-in for the Python IO paths: `gray_norm_pad` bit-equal to
oracle.to_grayscale_f32 + pad_image, PNM/PFM codecs agreeing with
io/images.py / io/writers.py, the PNG writer emitting files with
correct chunk CRCs (strict decoders reject a wrong IEND CRC), and the
prefetch PairLoader delivering pairs in order with bounded memory and
clean error propagation.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from deepmatching_stereo_matching_tpu import native
from deepmatching_stereo_matching_tpu.io import images, writers
from deepmatching_stereo_matching_tpu.oracle import reference as oracle
from deepmatching_stereo_matching_tpu.config import Config


pytestmark = pytest.mark.skipif(
    not native.available(),
    reason=f"native build unavailable: {native.build_error()}")


def oracle_gray_pad(img, ph, pw):
    g = oracle.to_grayscale_f32(img)
    out = np.zeros((ph, pw), dtype=np.float32)
    out[: g.shape[0], : g.shape[1]] = g
    return out


# ---------------------------------------------------------------------------
# gray_norm_pad parity (bit-exact vs the oracle prologue)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["u8_gray", "u8_rgb", "u8_dark", "u16"])
def test_gray_norm_pad_bit_equal(case):
    rng = np.random.default_rng(1)
    if case == "u8_gray":
        img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    elif case == "u8_rgb":
        img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    elif case == "u8_dark":
        # max <= 1.5: the oracle's range heuristic must NOT divide.
        img = rng.integers(0, 2, (37, 53), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (37, 53), dtype=np.uint16)
    got = native.gray_norm_pad(img, 48, 64)
    want = oracle_gray_pad(img, 48, 64)
    np.testing.assert_array_equal(got, want, err_msg=case)


# ---------------------------------------------------------------------------
# PNM codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,channels", [
    (np.uint8, 1), (np.uint8, 3), (np.uint16, 1)])
def test_pnm_roundtrip_and_python_agreement(tmp_path, dtype, channels):
    rng = np.random.default_rng(2)
    hi = 65536 if dtype == np.uint16 else 256
    shape = (11, 17) if channels == 1 else (11, 17, 3)
    img = rng.integers(0, hi, shape, dtype=dtype)
    path = str(tmp_path / "img.pgm")
    native.write_pnm(path, img)
    back, maxval = native.read_pnm(path)
    np.testing.assert_array_equal(back, img)
    assert maxval == hi - 1
    # Python reader agreement (io/images.py minimal PNM path).
    py = images._load_pnm(path)
    np.testing.assert_array_equal(py.reshape(img.shape), img)


def test_pnm_rejects_bad_headers(tmp_path):
    cases = {
        "nonnum.pgm": b"P5\n12abc 7\n255\n" + b"\0" * 100,
        "huge.pgm": b"P5\n9999999999 9999999999\n255\n",
        "negative.pgm": b"P5\n-3 7\n255\n",
        "truncated.pgm": b"P5\n8 8\n255\n" + b"\0" * 10,
    }
    for name, blob in cases.items():
        p = tmp_path / name
        p.write_bytes(blob)
        with pytest.raises(IOError):
            native.read_pnm(str(p))


# ---------------------------------------------------------------------------
# PFM codec
# ---------------------------------------------------------------------------


def test_pfm_roundtrip_and_python_agreement(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((9, 13)).astype(np.float32)
    data[0, 0] = np.inf
    n_path, p_path = str(tmp_path / "n.pfm"), str(tmp_path / "p.pfm")
    native.write_pfm(n_path, data)
    np.testing.assert_array_equal(native.read_pfm(n_path), data)
    np.testing.assert_array_equal(writers.read_pfm(n_path), data)
    writers.write_pfm(p_path, data)
    np.testing.assert_array_equal(native.read_pfm(p_path), data)


# ---------------------------------------------------------------------------
# PNG writer: chunk-level validity (CRCs!) + PIL read-back
# ---------------------------------------------------------------------------


def _check_png_chunks(path):
    """Parse the PNG and verify EVERY chunk CRC (incl. the empty IEND)."""
    blob = open(path, "rb").read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    off = 8
    types = []
    while off < len(blob):
        (length,) = struct.unpack(">I", blob[off: off + 4])
        ctype = blob[off + 4: off + 8]
        payload = blob[off + 8: off + 8 + length]
        (crc,) = struct.unpack(
            ">I", blob[off + 8 + length: off + 12 + length])
        assert crc == zlib.crc32(ctype + payload) & 0xFFFFFFFF, \
            f"bad CRC in {ctype!r} chunk"
        types.append(ctype)
        off += 12 + length
    assert types[0] == b"IHDR" and types[-1] == b"IEND"


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_png_write_valid_and_readable(tmp_path, kind):
    rng = np.random.default_rng(4)
    if kind == "gray8":
        img = rng.integers(0, 256, (10, 14), dtype=np.uint8)
    elif kind == "rgb8":
        img = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
    else:
        img = rng.integers(0, 65536, (10, 14), dtype=np.uint16)
    path = str(tmp_path / f"{kind}.png")
    native.write_png(path, img)
    _check_png_chunks(path)
    from PIL import Image

    with Image.open(path) as im:
        back = np.asarray(im)
    np.testing.assert_array_equal(back, img)


def test_png16_disparity_roundtrip(tmp_path):
    """io/writers.py png16 path routed through the native encoder."""
    disp = np.array([[1.5, np.nan], [0.25, 300.0]], dtype=np.float32)
    path = str(tmp_path / "d.png")
    writers.write_disparity_png16(path, disp)
    _check_png_chunks(path)
    back = writers.read_disparity_png16(path)
    np.testing.assert_allclose(back[0, 0], 1.5)
    assert np.isnan(back[0, 1])


# ---------------------------------------------------------------------------
# PairLoader
# ---------------------------------------------------------------------------


def _write_pair_files(tmp_path, n, h=21, w=33, seed=0):
    rng = np.random.default_rng(seed)
    lefts, rights, arrays = [], [], []
    for i in range(n):
        l_ = rng.integers(0, 256, (h, w), dtype=np.uint8)
        r_ = rng.integers(0, 256, (h, w), dtype=np.uint8)
        lp = str(tmp_path / f"{i}_l.pgm")
        rp = str(tmp_path / f"{i}_r.pgm")
        native.write_pnm(lp, l_)
        native.write_pnm(rp, r_)
        lefts.append(lp)
        rights.append(rp)
        arrays.append((l_, r_))
    return lefts, rights, arrays


def test_loader_order_values_backpressure(tmp_path):
    # n far above the in-flight budget (2*threads) exercises the
    # bounded-prefetch path; order and bit-exact values must hold.
    n, ph, pw = 24, 32, 48
    lefts, rights, arrays = _write_pair_files(tmp_path, n)
    with native.PairLoader(lefts, rights, ph, pw, num_threads=3) as ld:
        got = list(ld)
    assert [i for i, _, _ in got] == list(range(n))
    for i, left, right in got:
        np.testing.assert_array_equal(left,
                                      oracle_gray_pad(arrays[i][0], ph, pw))
        np.testing.assert_array_equal(right,
                                      oracle_gray_pad(arrays[i][1], ph, pw))


def test_loader_error_propagates(tmp_path):
    lefts, rights, _ = _write_pair_files(tmp_path, 3)
    (tmp_path / "bad.pgm").write_bytes(b"P5\n8 8\n255\n\0\0")
    lefts[1] = str(tmp_path / "bad.pgm")
    with native.PairLoader(lefts, rights, 32, 48) as ld:
        i0, _, _ = next(ld)
        assert i0 == 0
        with pytest.raises(IOError, match="truncated"):
            next(ld)


def test_loader_early_close_no_hang(tmp_path):
    lefts, rights, _ = _write_pair_files(tmp_path, 16)
    ld = native.PairLoader(lefts, rights, 32, 48, num_threads=2)
    next(ld)
    ld.close()  # workers blocked on backpressure must exit promptly


# ---------------------------------------------------------------------------
# runner integration: native stream == python stream, end to end
# ---------------------------------------------------------------------------


def test_pairs_from_paths_native_equals_python(tmp_path, monkeypatch):
    from deepmatching_stereo_matching_tpu import parallel
    from deepmatching_stereo_matching_tpu.parallel import runner

    cfg = Config(max_disparity=16, levels=2)
    h, w = 40, 56
    lefts, rights, _ = _write_pair_files(tmp_path, 4, h=h, w=w, seed=7)
    mesh = parallel.make_mesh(1, 1)
    nat = list(runner.pairs_from_paths(lefts, rights, cfg, h, w, mesh))
    monkeypatch.setenv("DMS_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    py = list(runner.pairs_from_paths(lefts, rights, cfg, h, w, mesh))
    assert len(nat) == len(py) == 4
    for (nl, nr), (pl, pr) in zip(nat, py):
        np.testing.assert_array_equal(nl, pl)
        np.testing.assert_array_equal(nr, pr)


def test_run_stream_from_native_loader(tmp_path):
    import jax

    from deepmatching_stereo_matching_tpu import parallel
    from deepmatching_stereo_matching_tpu.parallel import runner
    from deepmatching_stereo_matching_tpu.models import pipeline

    cfg = Config(max_disparity=16, levels=2)
    h, w = 40, 56
    lefts, rights, arrays = _write_pair_files(tmp_path, 4, h=h, w=w,
                                              seed=11)
    mesh = parallel.make_mesh(1, 1)
    collected = {}
    rep = runner.run_stream(
        runner.pairs_from_paths(lefts, rights, cfg, h, w, mesh),
        cfg, h, w, mesh, "tiled", batch_size=2,
        on_result=lambda i, out: collected.update({i: out}))
    assert rep.pairs_completed == 4
    # First pair must equal the direct single-device pipeline.
    want = pipeline.match_padded(
        oracle.pad_image(oracle.to_grayscale_f32(arrays[0][0]),
                         cfg.geometry(h, w)),
        oracle.pad_image(oracle.to_grayscale_f32(arrays[0][1]),
                         cfg.geometry(h, w)),
        cfg, h, w)
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.asarray(collected[0][k][0]), np.asarray(v))


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
class TestPngDecode:
    """Native PNG reader (zlib inflate + unfilter) vs PIL (the
    Middlebury/KITTI dataset formats must stream through the native
    input path)."""

    def test_rgb8_pil_parity(self, tmp_path):
        from PIL import Image
        rng = np.random.default_rng(0)
        # Both a noise image and a smooth ramp: PIL picks different
        # row filters (Sub/Up/Average/Paeth) for smooth content, so
        # this exercises the unfilter paths.
        ramp = (np.arange(61)[:, None] + np.arange(83)[None, :])
        smooth = np.stack([ramp, 2 * ramp, 3 * ramp], -1) % 256
        for img in (rng.integers(0, 256, (37, 53, 3), dtype="uint8"),
                    smooth.astype("uint8")):
            p = str(tmp_path / "t.png")
            Image.fromarray(img).save(p)
            arr, maxval = native.read_png(p)
            assert maxval == 255
            np.testing.assert_array_equal(arr, img)

    def test_gray16_pil_parity(self, tmp_path):
        from PIL import Image
        rng = np.random.default_rng(1)
        g16 = rng.integers(0, 65536, (23, 31), dtype="uint16")
        p = str(tmp_path / "g16.png")
        Image.fromarray(g16.astype("int32"), mode="I").convert(
            "I;16").save(p)
        arr, maxval = native.read_png(p)
        assert maxval == 65535 and arr.dtype == np.uint16
        np.testing.assert_array_equal(arr, g16)

    def test_rgba_drops_alpha(self, tmp_path):
        from PIL import Image
        rng = np.random.default_rng(2)
        rgba = rng.integers(0, 256, (16, 20, 4), dtype="uint8")
        p = str(tmp_path / "rgba.png")
        Image.fromarray(rgba, "RGBA").save(p)
        arr, _ = native.read_png(p)
        np.testing.assert_array_equal(arr, rgba[:, :, :3])

    def test_native_write_read_roundtrip(self, tmp_path):
        rng = np.random.default_rng(3)
        for img in (rng.integers(0, 256, (18, 22, 3), dtype="uint8"),
                    rng.integers(0, 256, (18, 22), dtype="uint8"),
                    rng.integers(0, 65536, (18, 22), dtype="uint16")):
            p = str(tmp_path / "rt.png")
            native.write_png(p, img)
            arr, _ = native.read_png(p)
            np.testing.assert_array_equal(arr, img)

    def test_read_image_sniffs_magic(self, tmp_path):
        rng = np.random.default_rng(4)
        img = rng.integers(0, 256, (12, 14, 3), dtype="uint8")
        png, ppm = str(tmp_path / "a.png"), str(tmp_path / "a.ppm")
        native.write_png(png, img)
        native.write_pnm(ppm, img)
        for p in (png, ppm):
            arr, maxval = native.read_image(p)
            assert maxval == 255
            np.testing.assert_array_equal(arr, img)

    def test_png_pairs_stream_through_native_loader(self, tmp_path):
        """PNG pairs flow through PairLoader bit-identically to the
        Python decode+grayscale+pad path."""
        from deepmatching_stereo_matching_tpu.oracle import (
            reference as oracle)

        cfg = Config(max_disparity=8, levels=2)
        h, w = 40, 56
        geom = cfg.geometry(h, w)
        rng = np.random.default_rng(5)
        lefts, rights, want = [], [], []
        for i in range(3):
            pair = []
            for side in ("l", "r"):
                img = rng.integers(0, 256, (h, w, 3), dtype="uint8")
                p = str(tmp_path / f"{i}_{side}.png")
                native.write_png(p, img)
                pair.append((p, img))
            lefts.append(pair[0][0])
            rights.append(pair[1][0])
            want.append(tuple(
                oracle.pad_image(oracle.to_grayscale_f32(img), geom)
                for _, img in pair))
        with native.PairLoader(lefts, rights, geom.padded_height,
                               geom.padded_width, num_threads=2) as ld:
            got = [(l, r) for _i, l, r in ld]
        assert len(got) == 3
        for (gl, gr), (wl, wr) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gr, wr)

    def test_corrupt_png_fails_cleanly(self, tmp_path):
        p = str(tmp_path / "bad.png")
        with open(p, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + b"garbage" * 4)
        with pytest.raises(IOError):
            native.read_png(p)
