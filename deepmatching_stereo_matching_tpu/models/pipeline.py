"""End-to-end jitted DeepMatching stereo pipeline (single device).

The reference runs its stages as separate NumPy passes on the host
(SURVEY.md §3.1); here C2-C12 are ONE jitted XLA program: the host/device
boundary sits exactly at image upload and disparity download (SURVEY.md
§3.1 note).  Both matching directions (L->R and the flipped R->L pass
needed for the consistency check, SURVEY.md §3.5) are batched together
on the leading axis so the device computes them in a single pass.

The pyramid level loop is unrolled (shapes halve per level -> unrolled,
not `lax.scan`, SURVEY.md C8).  The reference's recursive backtracking
[DM §3.3] is reformulated as dense argmax propagation with fixed shapes
(SURVEY.md §3.4): the bottom-up pass records pool-argmax offsets, and the
top-down pass hands each quadtree child its refined disparity bin via
vectorised gathers.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp

from ..config import Config, Geometry
from ..ops import costvol as costvol_ops
from ..ops import pool as pool_ops
from ..ops import postfilter as postfilter_ops
from . import descriptors


# ---------------------------------------------------------------------------
# Pyramid + backtracking (C5-C10)
# ---------------------------------------------------------------------------


def build_pyramid(cost0: jnp.ndarray, levels: int, lam: float
                  ) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Bottom-up aggregation (C8); returns (maps, args) as in the oracle."""
    maps = [cost0]
    args = []
    cur = cost0
    for _ in range(levels):
        sub, arg = pool_ops.pool3_subsample(cur)
        cur = pool_ops.aggregate_children(sub, lam)
        maps.append(cur)
        args.append(arg)
    return maps, args


def _select_at(values: jnp.ndarray, k: jnp.ndarray,
               acc_dtype) -> jnp.ndarray:
    """values[i, j, k[i, j]] as a one-hot compare + reduce.

    Mathematically identical to the gather — exactly one position
    matches, so the sum IS the selected element.  Whether a plain
    `take_along_axis` is cheaper on the GPU has not been measured.
    """
    d = jnp.arange(values.shape[-1], dtype=jnp.int32)
    sel = k[:, :, None] == d
    zero = jnp.zeros((), dtype=values.dtype)
    return jnp.sum(jnp.where(sel, values, zero), axis=-1, dtype=acc_dtype)


def backtrack_from(k: jnp.ndarray, args: List[jnp.ndarray]) -> jnp.ndarray:
    """Descend selected bins `k` through the recorded pool offsets.

    k is a (H, W) int32 map of winning disparity bins at level
    ``len(args)`` (relative to args[0]'s level); each step doubles the
    spatial grid and refines the bin via the recorded argmax offsets.
    Split out of `backtrack` so the W-tiled sharded pipeline
    (parallel/wtiled.py) can descend the replicated coarse levels, slice
    its tile, and continue locally through the same code.
    """
    for arg in reversed(args):
        kr = jnp.repeat(jnp.repeat(k, 2, axis=0), 2, axis=1)
        off = _select_at(arg, kr, jnp.int32)
        k = 2 * kr + off
    return k


def backtrack(maps: List[jnp.ndarray], args: List[jnp.ndarray]
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense top-down argmax propagation (SURVEY.md §3.4).

    Returns (disp_patch int32 (H0, W0), score float32 (H0, W0)).
    Matches oracle/reference.py:backtrack exactly (the one-hot reduce
    selects the same elements the oracle's take_along_axis gathers).
    """
    k = jnp.argmax(maps[len(args)], axis=-1).astype(jnp.int32)
    k = backtrack_from(k, args)
    score = _select_at(maps[0], k, jnp.float32)
    return k, score


def _select_dmajor(planes: jnp.ndarray, k: jnp.ndarray,
                   acc_dtype) -> jnp.ndarray:
    """planes[k[h, w], h, w] without a gather (D-MAJOR one-hot reduce).

    Leading-axis analogue of `_select_at`: exactly one plane matches
    per cell, so the masked sum IS the selected element, and the
    reduction never touches the minor (sublane, lane) layout.
    """
    ii = jnp.arange(planes.shape[0], dtype=jnp.int32)[:, None, None]
    zero = jnp.zeros((), dtype=planes.dtype)
    return jnp.sum(jnp.where(ii == k[None], planes, zero), axis=0,
                   dtype=acc_dtype)


def match_dmajor_xla(cost_dm: jnp.ndarray, levels: int, lam: float
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pyramid + backtracking on a D-MAJOR (D, H0, W0) volume.

    The layout the disparity-slab sharded strategy produces after its
    all_to_all reshard (parallel/sharded.py).  Pools and selects run
    along the leading axis; bit-identical to build_pyramid + backtrack
    (same ops, same order, transposed layout).
    """
    args = []
    cur = cost_dm
    for _ in range(levels):
        pooled, arg = pool_ops.pool3_subsample_dmajor(cur)
        cur = pool_ops.aggregate_children_dmajor(pooled, lam)
        args.append(arg)
    # Leading-axis argmax: first-max (smallest d) ties, always.
    k = jnp.argmax(cur, axis=0).astype(jnp.int32)
    for arg in reversed(args):
        kr = jnp.repeat(jnp.repeat(k, 2, axis=0), 2, axis=1)
        off = _select_dmajor(arg.astype(jnp.int32), kr, jnp.int32)
        k = 2 * kr + off
    score = _select_dmajor(cost_dm, k, jnp.float32)
    return k, score


# ---------------------------------------------------------------------------
# Single-direction pipeline on a padded grayscale image pair
# ---------------------------------------------------------------------------


def match_from_descriptors(desc_src: jnp.ndarray, desc_tgt: jnp.ndarray,
                           cfg: Config, geom: Geometry,
                           reverse: bool = False, origin_offset: int = 0
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cost volume + pyramid + backtracking on prepared descriptors.

    The shared core of both matching directions and of the sharded
    tile-local pipeline (which passes halo-extended target descriptors
    via `origin_offset`, SURVEY.md §5.7).
    """
    if cfg.dtype != "float32":
        # bf16 mode (SURVEY.md §7 hard part 5): descriptors are built
        # and normalised in f32, then the cost volume and pyramid run in
        # bf16 (half the bytes); dot products still accumulate in f32.
        # Not bit-comparable to the oracle — quality is held to the
        # bad-pixel bound instead (tests/test_bf16.py).
        dt = jnp.dtype(cfg.dtype)
        desc_src = desc_src.astype(dt)
        desc_tgt = desc_tgt.astype(dt)
    with jax.named_scope("costvol"):
        cost0 = costvol_ops.cost_volume(
            desc_src, desc_tgt, geom.disparities, cfg.patch_size,
            cfg.max_disparity, reverse=reverse,
            origin_offset=origin_offset)
    with jax.named_scope("pyramid"):
        maps, args = build_pyramid(cost0, geom.levels, cfg.lam)
    with jax.named_scope("backtrack"):
        return backtrack(maps, args)


def one_direction(left: jnp.ndarray, right: jnp.ndarray, cfg: Config,
                  geom: Geometry, reverse: bool = False
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Hp, Wp) padded pair -> (disp_patch, score), both (H0, W0)."""
    with jax.named_scope("descriptors"):
        desc_src = descriptors.left_descriptors(left, cfg)
        desc_tgt = descriptors.right_sliding_descriptors(right, cfg)
    return match_from_descriptors(desc_src, desc_tgt, cfg, geom,
                                  reverse=reverse)


# ---------------------------------------------------------------------------
# Full pipeline: both directions + consistency + densification (C11-C12)
# ---------------------------------------------------------------------------


def densify(patchwise: jnp.ndarray, patch_size: int) -> jnp.ndarray:
    return jnp.repeat(jnp.repeat(patchwise, patch_size, axis=0),
                      patch_size, axis=1)


def lr_consistency(disp_l: jnp.ndarray, disp_r: jnp.ndarray, tau: float,
                   num_disparities: int) -> jnp.ndarray:
    """valid[y, x] = |dL[y,x] - dR[y, x - dL[y,x]]| <= tau.

    Since dL is bounded by `num_disparities`, the data-dependent gather
    dR[y, x - dL] is computed as a `lax.scan` over the possible shifts
    s: each step dynamic-slices the left-padded dR by s and selects it
    where dL == s — windowed copies + elementwise selects,
    bit-identical to the gather.
    """
    h, w = disp_l.shape
    pad = jnp.full((h, num_disparities), jnp.iinfo(jnp.int32).min // 2,
                   dtype=disp_r.dtype)
    padded = jnp.concatenate([pad, disp_r], axis=1)

    def body(acc, s):
        shifted = jax.lax.dynamic_slice(
            padded, (jnp.int32(0), num_disparities - s), (h, w))
        return jnp.where(disp_l == s, shifted, acc), None

    # full_like keeps the carry's sharding/varying-axes type equal to
    # the per-step output under shard_map (a fresh jnp.full would not).
    init = jnp.full_like(disp_r, jnp.iinfo(jnp.int32).min // 2)
    d_r, _ = jax.lax.scan(
        body, init, jnp.arange(num_disparities, dtype=jnp.int32))
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    in_range = disp_l <= xs
    return in_range & (jnp.abs(disp_l - d_r) <= tau)


def lr_consistency_patch(disp_l: jnp.ndarray, disp_r: jnp.ndarray,
                         tau: float, num_disparities: int, patch_size: int
                         ) -> jnp.ndarray:
    """Pixel-level LR validity from PATCH-level disparity maps.

    Bit-identical to `lr_consistency` on the densified maps, exploiting
    that both maps are constant over p x p patch blocks: with
    dL = p*q + r, pixel column x = p*J + c reads dR's patch column
    J - q (when c >= r) or J - q - 1 (when c < r).  The shift scan
    therefore runs over q in [0, D/p) on (H0, W0) patch maps — p times
    fewer steps on p^2 times fewer elements than the pixel formulation.

    Args:
      disp_l/disp_r: (H0, W0) int32 patch disparities.
    Returns: (H0*p, W0*p) bool pixel validity.
    """
    h0, _ = disp_l.shape
    p = patch_size
    n_q = (num_disparities + p - 1) // p
    sentinel = jnp.iinfo(jnp.int32).min // 2
    pad = jnp.full((h0, n_q + 1), sentinel, dtype=disp_r.dtype)
    padded = jnp.concatenate([pad, disp_r], axis=1)
    return lr_consistency_patch_padded(disp_l, padded, tau,
                                       num_disparities, patch_size)


def lr_consistency_patch_padded(disp_l: jnp.ndarray, padded: jnp.ndarray,
                                tau: float, num_disparities: int,
                                patch_size: int, col0_patches=0
                                ) -> jnp.ndarray:
    """`lr_consistency_patch` core on a PRE-PADDED right disparity map.

    `padded` is (H0, n_q + 1 + W0): the last W0 columns are dR for the
    W-range being checked, the first n_q + 1 columns are the patch
    columns immediately to its LEFT — the sentinel out-of-image fill in
    the unsharded case, or the W-neighbour tile's trailing columns
    (exchanged via `ppermute`) in the W-tiled sharded case
    (parallel/wtiled.py).  `col0_patches` is the global patch-column
    index of disp_l[:, 0] (may be traced), used for the in-range
    x >= dL test.
    """
    p = patch_size
    n_q = (num_disparities + p - 1) // p
    h0 = disp_l.shape[0]
    w0 = padded.shape[1] - (n_q + 1)
    sentinel = jnp.iinfo(jnp.int32).min // 2
    disp_r = padded[:, n_q + 1:]
    q_l = disp_l // p
    r_l = disp_l % p

    def body(carry, s):
        a, b = carry
        # dR[I, J - s] and dR[I, J - s - 1] for patches with q == s.
        sh_a = jax.lax.dynamic_slice(padded, (jnp.int32(0), n_q + 1 - s),
                                     (h0, w0))
        sh_b = jax.lax.dynamic_slice(padded, (jnp.int32(0), n_q - s),
                                     (h0, w0))
        take = q_l == s
        return (jnp.where(take, sh_a, a), jnp.where(take, sh_b, b)), None

    init = (jnp.full_like(disp_r, sentinel), jnp.full_like(disp_r, sentinel))
    (d_r_a, d_r_b), _ = jax.lax.scan(
        body, init, jnp.arange(n_q, dtype=jnp.int32))

    ok_a = jnp.abs(disp_l - d_r_a) <= tau
    ok_b = jnp.abs(disp_l - d_r_b) <= tau
    # Per sub-column c: select A/B on c >= r, and in-range x >= dL.
    c = jnp.arange(p, dtype=jnp.int32)[None, None, :]
    j0 = jnp.asarray(col0_patches, jnp.int32)
    xs = ((j0 + jnp.arange(w0, dtype=jnp.int32)) * p)[None, :, None] + c
    valid = jnp.where(c >= r_l[:, :, None], ok_a[:, :, None],
                      ok_b[:, :, None])
    valid &= disp_l[:, :, None] <= xs
    return jnp.repeat(valid.reshape(h0, w0 * p), p, axis=0)


def match_padded_core(left_p: jnp.ndarray, right_p: jnp.ndarray,
                      cfg: Config, geom: Geometry,
                      large: bool = False) -> Dict[str, jnp.ndarray]:
    """Padded pair -> PADDED (Hp, Wp) outputs; the shard-local core.

    Uses only `geom`'s padded dims / levels / disparities, never the true
    image size, so the sharded pipeline (parallel/sharded.py) can call it
    per H-tile with a tile-local Geometry and crop outside the shard map.

    `large=True` runs the two matching directions in turn (lax.map)
    instead of vmapped, which halves the peak memory of the cost
    volume and pyramid for large images or disparity ranges.
    """
    if cfg.lr_check and cfg.lr_mode == "flip":
        # Batch L->R with the flipped R->L pass (d_R(x) = d'_L(W-1-x)).
        lefts = jnp.stack([left_p, right_p[:, ::-1]])
        rights = jnp.stack([right_p, left_p[:, ::-1]])
        if large:
            (disp_patch, score_patch) = jax.lax.map(
                lambda lr: one_direction(lr[0], lr[1], cfg, geom),
                (lefts, rights))
        else:
            (disp_patch, score_patch) = jax.vmap(
                lambda l, r: one_direction(l, r, cfg, geom)
            )(lefts, rights)
        disp_fwd, disp_rev = disp_patch[0], disp_patch[1]
        score = score_patch[0]
        # Flip at patch level: densify(x)[:, ::-1] == densify(x[:, ::-1])
        # for patch-aligned padded widths (4-blocks hold equal values).
        disp_r_patch = disp_rev[:, ::-1]
    elif cfg.lr_check:
        # 'direct': match right->left with +d targets — descriptors are
        # shared between the two directions, and no global flip is
        # needed (this is the form that shards over W-tiles).
        with jax.named_scope("descriptors"):
            desc_l_p = descriptors.left_descriptors(left_p, cfg)
            desc_l_s = descriptors.right_sliding_descriptors(left_p, cfg)
            desc_r_p = descriptors.left_descriptors(right_p, cfg)
            desc_r_s = descriptors.right_sliding_descriptors(right_p, cfg)
        disp_fwd, score = match_from_descriptors(
            desc_l_p, desc_r_s, cfg, geom)
        disp_rev, _ = match_from_descriptors(
            desc_r_p, desc_l_s, cfg, geom, reverse=True)
        disp_r_patch = disp_rev
    else:
        disp_fwd, score = one_direction(left_p, right_p, cfg, geom)
        disp_r_patch = None

    disp_px = densify(disp_fwd, cfg.patch_size)
    score_px = densify(score, cfg.patch_size)

    valid = jnp.ones(disp_px.shape, dtype=bool)
    disp_r_px = jnp.zeros(disp_px.shape, dtype=jnp.int32)
    if cfg.lr_check:
        disp_r_px = densify(disp_r_patch, cfg.patch_size)
        with jax.named_scope("lr_check"):
            valid &= lr_consistency_patch(disp_fwd, disp_r_patch,
                                          cfg.tau, geom.disparities,
                                          cfg.patch_size)
    if cfg.min_score > 0.0:
        valid &= score_px >= cfg.min_score

    out = jnp.where(valid, disp_px.astype(jnp.float32),
                    jnp.float32(cfg.invalid_value))
    return {
        "disparity": out,
        "disparity_raw": disp_px,
        "valid": valid,
        "score": score_px,
        "disparity_right": disp_r_px,
    }


def crop(outputs: Dict[str, jnp.ndarray], height: int, width: int
         ) -> Dict[str, jnp.ndarray]:
    """Crop padded (… Hp, Wp) outputs back to the true image size."""
    return {k: v[..., :height, :width] for k, v in outputs.items()}


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def match_padded(left_p: jnp.ndarray, right_p: jnp.ndarray, cfg: Config,
                 height: int, width: int) -> Dict[str, jnp.ndarray]:
    """Jitted single-device pipeline: padded f32 pair -> cropped outputs.

    `cfg`, `height`, `width` are static; retracing happens only per
    (shape, config), as with any XLA program.
    """
    geom = cfg.geometry(height, width)
    out = crop(match_padded_core(left_p, right_p, cfg, geom),
               height, width)
    return apply_postfilter(out, cfg)


def apply_postfilter(out: Dict[str, jnp.ndarray], cfg: Config
                     ) -> Dict[str, jnp.ndarray]:
    """C13 tail on cropped outputs (leading batch dims allowed).

    Runs outside the shard_map cores — a k*k median window crosses
    H-tile boundaries, and at O(H*W) this tail is cheapest left to
    XLA's automatic partitioning (ops/postfilter.py docstring).
    """
    if not (cfg.median_filter or cfg.fill_invalid):
        return out
    f = lambda d: postfilter_ops.postfilter(  # noqa: E731
        d, cfg.median_filter, cfg.fill_invalid)
    disp = out["disparity"]
    for _ in range(disp.ndim - 2):
        f = jax.vmap(f)
    return {**out, "disparity": f(disp)}
