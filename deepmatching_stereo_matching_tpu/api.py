"""Public API: dense stereo matching on the current JAX backend.

Mirrors the reference's single entry point (SURVEY.md §3.1) but jitted
end-to-end on device.  Host work is exactly image normalisation/padding
on the way in (C1) and array download on the way out (C14), per the
layer map in SURVEY.md §1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .config import Config
from .models import pipeline
from .oracle import reference as _oracle


@dataclasses.dataclass
class MatchResult:
    """Host-side result of one stereo match (same fields as the oracle)."""

    disparity: np.ndarray        # float32 (H, W); invalid = cfg.invalid_value
    disparity_raw: np.ndarray    # int32 (H, W) unfiltered L->R disparities
    valid: np.ndarray            # bool (H, W)
    score: np.ndarray            # float32 (H, W) level-0 correlation
    disparity_right: Optional[np.ndarray]  # int32 (H, W), None w/o lr_check


def preprocess(image: np.ndarray, cfg: Config, height: int, width: int
               ) -> np.ndarray:
    """Grayscale-normalise and zero-pad one image to pipeline geometry."""
    gray = _oracle.to_grayscale_f32(image)
    geom = cfg.geometry(height, width)
    return _oracle.pad_image(gray, geom)


def match_stereo(left, right, cfg: Config = Config(),
                 debug_checks: bool = False) -> MatchResult:
    """Dense disparity for a rectified pair, computed on device.

    Accepts uint8/float, grayscale or RGB arrays of equal shape.
    `debug_checks` runs the pipeline with on-device checkify invariant
    guards (finite scores, in-range disparity bins; utils/checks.py) —
    a sanitizer mode, not for production throughput.
    """
    from .utils import checks

    left, right = checks.validate_images(left, right)
    h, w = left.shape[:2]
    lp = jnp.asarray(preprocess(left, cfg, h, w))
    rp = jnp.asarray(preprocess(right, cfg, h, w))
    if debug_checks:
        out = checks.checked_match_padded(lp, rp, cfg, h, w)
    else:
        out = pipeline.match_padded(lp, rp, cfg, h, w)
    return MatchResult(
        disparity=np.asarray(out["disparity"]),
        disparity_raw=np.asarray(out["disparity_raw"], dtype=np.int32),
        valid=np.asarray(out["valid"]),
        score=np.asarray(out["score"]),
        disparity_right=(np.asarray(out["disparity_right"], dtype=np.int32)
                         if cfg.lr_check else None),
    )
