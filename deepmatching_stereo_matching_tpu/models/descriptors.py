"""On-device patch descriptors (C2+C3, SURVEY.md §2.1).

jnp implementations matching the NumPy oracle
(`oracle/reference.py:left_descriptors` / `right_sliding_descriptors`)
element-for-element in float32: raw-intensity 'patch' mode and the
dense-SIFT-like 'grad_hist' mode [DM §3.1].  These run inside the jitted
pipeline, where XLA fuses them with the correlation prologue.
"""

from __future__ import annotations

import functools

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import Config
from ..ops.ordered import ordered_sum

_EPS = 1e-8


def _gradient_1d(img: jnp.ndarray, axis: int) -> jnp.ndarray:
    """np.gradient semantics: central differences, one-sided at edges.

    Static slices rather than an index gather; same elements, bitwise
    identical to np.gradient.
    """
    n = img.shape[axis]
    sl = functools.partial(jax.lax.slice_in_dim, img, axis=axis)
    interior = (sl(2, n) - sl(0, n - 2)) * jnp.float32(0.5)
    first = sl(1, 2) - sl(0, 1)
    last = sl(n - 1, n) - sl(n - 2, n - 1)
    return jnp.concatenate([first, interior, last], axis=axis)


def hist_from_gradients(gx: jnp.ndarray, gy: jnp.ndarray,
                        bins: int = 8) -> jnp.ndarray:
    """(gx, gy) -> magnitude-weighted orientation histogram (..., bins).

    The shared tail of `grad_hist_pixels` and the halo-corrected sharded
    feature builder (parallel/wtiled.py).  Comparison-based octant
    binning + L1 magnitude, EXACT float ops only, matching
    oracle/reference.py:_grad_hist_pixels — sqrt/arctan2 compile to
    fusion-dependent FMA/veclib code whose ULP drift flips bins; see
    the oracle docstring.
    """
    if bins != 8:
        raise ValueError("grad_hist is defined for 8 orientation bins")
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    mag = ax + ay
    idx_up = jnp.where(gx > 0, jnp.where(ay >= ax, 5, 4),
                       jnp.where(ay > ax, 6, 7))
    idx_dn = jnp.where(gx >= 0, jnp.where(ay > ax, 2, 3),
                       jnp.where(ay >= ax, 1, 0))
    idx = jnp.where(gy >= 0, idx_up, idx_dn)
    return jax.nn.one_hot(idx, bins, dtype=jnp.float32) * mag[..., None]


def grad_hist_pixels(img: jnp.ndarray, bins: int = 8) -> jnp.ndarray:
    """Per-pixel orientation histogram, (H, W) -> (H, W, bins).

    Matches oracle/reference.py:_grad_hist_pixels (magnitude-weighted
    hard assignment into `bins` orientation bins).
    """
    gy = _gradient_1d(img, 0)
    gx = _gradient_1d(img, 1)
    return hist_from_gradients(gx, gy, bins)


def pixel_features(img: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    if cfg.descriptor == "patch":
        return img[..., None]
    return grad_hist_pixels(img)


def _normalize(desc: jnp.ndarray) -> jnp.ndarray:
    norm = jnp.sqrt(ordered_sum(desc * desc))[..., None]
    return desc / jnp.maximum(norm, jnp.float32(_EPS))


def _center(desc: jnp.ndarray) -> jnp.ndarray:
    mean = ordered_sum(desc)[..., None] / jnp.float32(desc.shape[-1])
    return desc - mean


def patch_descriptors(feat: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """(Hp', W', F) pixel features -> (H0, W0, C) patch descriptors.

    The feature->descriptor stage of `left_descriptors`, split out so the
    W-tiled sharded path (parallel/wtiled.py) can feed halo-corrected
    tile-local features through the identical code.
    """
    p = cfg.patch_size
    h, w, f = feat.shape
    h0, w0 = h // p, w // p
    blocks = feat[: h0 * p, : w0 * p].reshape(h0, p, w0, p, f)
    desc = blocks.transpose(0, 2, 1, 3, 4).reshape(h0, w0, p * p * f)
    if cfg.center_descriptors:
        desc = _center(desc)
    return _normalize(desc)


def sliding_descriptors(feat: jnp.ndarray, cfg: Config,
                        col0: int = 0,
                        width_global: Optional[int] = None) -> jnp.ndarray:
    """(Hp', W', F) features -> (H0, W', C) descriptors at every column.

    Entry [i, x] describes the patch with top-left pixel (p*i, col0+x) in
    GLOBAL coordinates; windows whose global start falls outside
    [0, width_global - p] are all-zero.  With col0=0 and width_global=W'
    this is exactly the unsharded rule (partial right-edge windows are
    zeroed; nothing starts left of 0).  A W-tile passes its halo-extended
    feature slab with col0 = tile_start - halo so out-of-image halo
    columns zero out — zero descriptors correlate to 0, which is the
    unsharded out-of-range cost rule (ops/costvol.py).

    `col0` may be a traced scalar (e.g. derived from lax.axis_index).
    """
    p = cfg.patch_size
    h, w, f = feat.shape
    if width_global is None:
        width_global = w
    h0 = h // p
    rows = feat[: h0 * p].reshape(h0, p, w, f)
    # windows[i, x0, dr, dc, f] = rows[i, dr, x0 + dc, f]
    shifted = [
        jnp.pad(rows[:, :, dc:, :], ((0, 0), (0, 0), (0, dc), (0, 0)))
        for dc in range(p)
    ]
    windows = jnp.stack(shifted, axis=3)          # (H0, p, W', p, F)
    windows = windows.transpose(0, 2, 1, 3, 4)    # (H0, W', p, p, F)
    desc = windows.reshape(h0, w, p * p * f)
    xg = jnp.asarray(col0, jnp.int32) + jnp.arange(w, dtype=jnp.int32)
    ok = (xg >= 0) & (xg <= width_global - p)
    desc = jnp.where(ok[None, :, None], desc, jnp.float32(0.0))
    if cfg.center_descriptors:
        desc = _center(desc)
    return _normalize(desc)


def left_descriptors(img: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """(Hp, Wp) -> (H0, W0, C): non-overlapping patches at stride p."""
    return patch_descriptors(pixel_features(img, cfg), cfg)


def right_sliding_descriptors(img: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """(Hp, Wp) -> (H0, Wp, C): patch descriptors at EVERY column offset.

    Entry [i, x0] describes the patch with top-left corner (p*i, x0);
    windows overrunning the right edge (x0 > Wp - p) are all-zero, as in
    the oracle.
    """
    return sliding_descriptors(pixel_features(img, cfg), cfg)
