"""Runtime invariant guards (SURVEY.md §5.2 sanitizers).

XLA purity makes data races structurally absent; what CAN go wrong on
device is numeric: non-finite values sneaking into the cost volume
(bad input decode, overflowing custom descriptors) or an index bug
pushing disparity bins out of range.  This module provides:

  * `validate_images` — host-side input validation (shape, dtype,
    finiteness) with precise error messages, used by the API boundary.
  * `checked_match_padded` — the pipeline wrapped in
    `jax.experimental.checkify` user checks asserting the pipeline's
    core invariants ON DEVICE: finite scores, disparity bins inside
    [0, D), validity mask consistent with the NaN sentinel.  The
    deliberate NaN sentinel in `disparity` is applied AFTER the checked
    stages, so the checks carry no false positives.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import Config


def validate_images(left: np.ndarray, right: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Raise ValueError with a precise message on malformed inputs."""
    left = np.asarray(left)
    right = np.asarray(right)
    for name, img in (("left", left), ("right", right)):
        if img.ndim not in (2, 3):
            raise ValueError(
                f"{name} image must be (H, W) or (H, W, C), got shape "
                f"{img.shape}")
        if img.ndim == 3 and img.shape[2] not in (3, 4):
            raise ValueError(
                f"{name} image has {img.shape[2]} channels; expected "
                f"grayscale, RGB, or RGBA")
        if img.size == 0:
            raise ValueError(f"{name} image is empty: shape {img.shape}")
        if np.issubdtype(img.dtype, np.floating) \
                and not np.isfinite(img).all():
            raise ValueError(f"{name} image contains NaN/inf values")
    if left.shape != right.shape:
        raise ValueError(
            f"left/right shapes differ: {left.shape} vs {right.shape}")
    return left, right


def checked_match_padded(left_p, right_p, cfg: Config, height: int,
                         width: int) -> Dict:
    """`pipeline.match_padded` with on-device checkify invariants.

    Returns the outputs dict; raises `jax.experimental.checkify.JaxRuntimeError`
    (via err.throw()) when an invariant is violated.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import checkify

    from ..models import pipeline

    geom = cfg.geometry(height, width)

    def run(lp, rp):
        checkify.check(jnp.isfinite(lp).all() & jnp.isfinite(rp).all(),
                       "non-finite values in padded input images")
        out = pipeline.match_padded_core(lp, rp, cfg, geom)
        checkify.check(jnp.isfinite(out["score"]).all(),
                       "non-finite correlation scores")
        raw = out["disparity_raw"]
        checkify.check(((raw >= 0) & (raw < geom.disparities)).all(),
                       "disparity bin out of range [0, D)")
        if np.isnan(cfg.invalid_value):
            disp = out["disparity"]
            nan_iff_invalid = jnp.isnan(disp) == ~out["valid"]
            checkify.check(nan_iff_invalid.all(),
                           "NaN sentinel inconsistent with validity mask")
        # Post-filter AFTER the checks (fill_invalid rewrites the NaN
        # sentinel, so the sentinel/validity invariant is checked on the
        # pre-filter values) so the checked path stays the normal
        # pipeline plus checks, never a divergent one.
        return pipeline.apply_postfilter(
            pipeline.crop(out, height, width), cfg)

    checked = checkify.checkify(run, errors=checkify.user_checks)
    err, out = jax.jit(checked)(left_p, right_p)
    err.throw()
    return out
