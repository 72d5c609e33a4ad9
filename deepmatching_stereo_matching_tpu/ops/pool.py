"""Pyramid level ops (C5-C7): disparity max-pool + subsample, quadtree
merge, power rectification — jnp reference implementations.

Tie-breaking is deterministic (smallest resulting disparity wins), which
makes every run bit-reproducible across shardings (SURVEY.md §5.2) and
identical to the NumPy oracle (`oracle/reference.py:pool3_subsample` /
`aggregate_children`).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def pool3_subsample(maps: jnp.ndarray, lo_pad: jnp.ndarray | None = None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """3-wide max-pool along d + x2 subsample, with argmax offsets.

    Returns (sub, arg), both (H, W, D//2); arg[..., k] in {-1, 0, +1} is
    the offset of the pool winner around d = 2k (pad value -1.0 < every
    valid correlation, so winners always point in range; ties pick the
    smallest d).

    Computed subsample-first: only the even-d pool windows are ever
    needed, and window {2k-1, 2k, 2k+1} is {odd[k-1], even[k], odd[k]}
    after deinterleaving maps into even/odd disparity planes — two
    strided slices plus pure elementwise max/compare, no (H, W, D, 3)
    stack or cross-axis argmax.  The comparison chain (lo first, then
    centre, then hi) reproduces NumPy first-max argmax semantics
    bit-for-bit (oracle/reference.py:pool3_subsample).  arg is int8 to
    quarter the HBM traffic of the recorded backtracking indices.

    `lo_pad` overrides the d = -1 window element of the FIRST pool
    window: by default a -1.0 plane (out of range, never wins), but a
    disparity-slab-sharded pyramid passes the previous slab's last odd
    plane here (parallel/ringd.py halo exchange), making a slab-local
    pool bit-identical to the unsharded one.
    """
    h, w, d = maps.shape
    even = maps[:, :, 0::2]                               # d = 2k
    odd = maps[:, :, 1::2]                                # d = 2k+1
    if lo_pad is None:
        pad = jnp.full((h, w, 1), -1.0, dtype=maps.dtype)
    else:
        pad = lo_pad.astype(maps.dtype)[:, :, None]
    lo = jnp.concatenate([pad, odd[:, :, :-1]], axis=2)   # d = 2k-1
    pooled = jnp.maximum(jnp.maximum(lo, even), odd)
    arg = jnp.where(
        pooled == lo, jnp.int8(-1),
        jnp.where(pooled == even, jnp.int8(0), jnp.int8(1)))
    return pooled, arg


def aggregate_children(sub: jnp.ndarray, lam: float) -> jnp.ndarray:
    """Quadtree 4-child average + x**lam rectification ([DM §3.2])."""
    h, w, k = sub.shape
    quad = sub.reshape(h // 2, 2, w // 2, 2, k)
    # Fixed summation order — identical to the oracle and across
    # shardings; constants in the map dtype so bf16 maps stay bf16.
    merged = ((quad[:, 0, :, 0] + quad[:, 0, :, 1])
              + (quad[:, 1, :, 0] + quad[:, 1, :, 1])
              ) * jnp.asarray(0.25, sub.dtype)
    return jnp.power(merged, jnp.asarray(lam, sub.dtype))


def pool3_subsample_dmajor(maps: jnp.ndarray,
                           lo_pad: jnp.ndarray | None = None
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """`pool3_subsample` on the D-MAJOR (D, H, W) layout.

    Identical values and tie order; the even/odd deinterleave becomes a
    leading-axis stride.  Used by the disparity-slab sharded strategies
    (parallel/sharded.py, parallel/ringd.py), whose volumes are D-major.
    """
    even = maps[0::2]                                     # d = 2k
    odd = maps[1::2]                                      # d = 2k+1
    if lo_pad is None:
        pad = jnp.full((1,) + maps.shape[1:], -1.0, dtype=maps.dtype)
    else:
        pad = lo_pad.astype(maps.dtype)[None]
    lo = jnp.concatenate([pad, odd[:-1]], axis=0)         # d = 2k-1
    pooled = jnp.maximum(jnp.maximum(lo, even), odd)
    arg = jnp.where(
        pooled == lo, jnp.int8(-1),
        jnp.where(pooled == even, jnp.int8(0), jnp.int8(1)))
    return pooled, arg


def aggregate_children_dmajor(sub: jnp.ndarray, lam: float) -> jnp.ndarray:
    """`aggregate_children` on the D-MAJOR (K, H, W) layout (same
    values, same ((q00+q01)+(q10+q11))*0.25 order)."""
    k, h, w = sub.shape
    quad = sub.reshape(k, h // 2, 2, w // 2, 2)
    merged = ((quad[:, :, 0, :, 0] + quad[:, :, 0, :, 1])
              + (quad[:, :, 1, :, 0] + quad[:, :, 1, :, 1])
              ) * jnp.asarray(0.25, sub.dtype)
    return jnp.power(merged, jnp.asarray(lam, sub.dtype))
