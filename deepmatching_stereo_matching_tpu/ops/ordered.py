"""Reductions with a fixed summation order.

XLA's GPU reduction emitter picks its summation order from the shape of
the whole array (vectorisation width, threads per row), so the same
16-element sum can round differently in a batch of 8 than in a batch
of 1 — and differently on each shard of a mesh.  Written as explicit
elementwise adds, every element is summed in the same order whatever
the batch, layout or sharding, which keeps sharded outputs bitwise
equal to the unsharded pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ordered_sum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Sum over `axis` as a pairwise tree of elementwise adds.

    Level by level, element k is added to element k + n//2; an odd
    element out is carried to the next level unchanged.
    """
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        s = (jax.lax.slice_in_dim(x, 0, half, axis=axis)
             + jax.lax.slice_in_dim(x, half, 2 * half, axis=axis))
        if n % 2:
            s = jnp.concatenate(
                [s, jax.lax.slice_in_dim(x, 2 * half, n, axis=axis)],
                axis=axis)
        x, n = s, half + n % 2
    return jax.lax.index_in_dim(x, 0, axis=axis, keepdims=False)
