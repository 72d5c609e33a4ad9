"""Level-0 correlation cost volume (C4).

The reference computes this with Python loops over patches and
disparities (BASELINE.json:5 "per-patch correlation kernel, NumPy/loop
code"; SURVEY.md §3.2).  Here it is ONE XLA expression over all
disparities: descriptors are laid out channel-major, the target columns
of every (patch column, disparity) pair are gathered at once, and the
f32 products are summed over the channels in a fixed order
(ops/ordered.py).  XLA fuses gather, products and sum into one loop
(the (C, H0, W0, D) products need not be stored).  No matrix unit is
involved, so TF32 cannot enter, and every entry rounds the same
whatever the batch or sharding — XLA's own reduce does not (its GPU
summation order depends on the array's shape).

Two generalisations serve the sharded pipeline (SURVEY.md §5.7):
  * `reverse=True` computes the right-to-left volume directly
    (target x0 = p*j + d on the LEFT image's sliding descriptors), so
    the consistency pass needs no global image flip — flips do not
    shard over W-tiles, neighbour halos do.
  * `origin_offset` (in patch columns) says how far the *target*
    descriptor array extends to the left of the *source* patch grid's
    origin — nonzero when a W-tile carries a halo of neighbour columns.
"""

from __future__ import annotations

import jax.numpy as jnp

from .ordered import ordered_sum


def cost_volume(desc_src: jnp.ndarray, desc_tgt: jnp.ndarray,
                disparities: int, patch_size: int, max_disparity: int,
                reverse: bool = False, origin_offset: int = 0,
                d_offset: int = 0) -> jnp.ndarray:
    """C0[i, j, d] = max(0, <src[i, j], tgt[i, p*j -+ d + p*origin_offset]>).

    Forward (reverse=False): src = left patches, tgt = right sliding
    descriptors, target column p*j - d.  Reverse: src = right patches,
    tgt = LEFT sliding descriptors, target column p*j + d.

    Out-of-range targets score 0 — in the unextended case (origin_offset
    = 0, tgt width = p * src width) this masks p*j - d < 0; when the
    target array carries halos, out-of-image halo columns must already
    be zeroed by the caller (zero descriptors correlate to 0, which is
    exactly the unsharded rule).  Padded bins (d >= max_disparity) score
    0.  Matches oracle/reference.py:cost_volume in f32.

    Args:
      desc_src: (H0, W0, C) L2-normalised source patch descriptors.
      desc_tgt: (H0, Wt, C) target sliding descriptors,
        Wt = p * (W0 + origin_offset) + any right extension.
      disparities: D0, padded disparity count (static).
      patch_size: p (static).
      max_disparity: effective search bound (static).
      reverse: direction of the disparity shift (static).
      origin_offset: left extension of desc_tgt in patch columns (static).
      d_offset: first GLOBAL disparity bin computed by this call — the
        volume covers global bins [d_offset, d_offset+disparities),
        which is how a disparity slab shards over a mesh axis
        (SURVEY.md §2.3 "disparity-slab parallelism").  May be a traced
        scalar (e.g. `axis_index * slab`), so one shard_map program
        serves every slab.

    Returns: (H0, W0, disparities) in desc_src's dtype.
    """
    w0 = desc_src.shape[1]
    wt = desc_tgt.shape[1]
    xs = jnp.arange(w0, dtype=jnp.int32) * patch_size \
        + patch_size * origin_offset
    ds = jnp.arange(disparities, dtype=jnp.int32) \
        + jnp.asarray(d_offset, dtype=jnp.int32)
    x0 = (xs[:, None] + ds[None, :]) if reverse \
        else (xs[:, None] - ds[None, :])                     # (W0, D)
    valid = (x0 >= 0) & (x0 < wt) & (ds < max_disparity)[None, :]
    # Channel-major, f32 products regardless of storage dtype (bf16).
    src = jnp.moveaxis(desc_src.astype(jnp.float32), -1, 0)  # (C, H0, W0)
    tgt = jnp.moveaxis(desc_tgt.astype(jnp.float32), -1, 0)  # (C, H0, Wt)
    tgt = jnp.take(tgt, jnp.clip(x0, 0, wt - 1), axis=2)     # (C, H0, W0, D)
    corr = jnp.maximum(ordered_sum(src[..., None] * tgt, axis=0), 0.0)
    dt = desc_src.dtype
    return jnp.where(valid[None], corr.astype(dt), jnp.zeros((), dt))
