"""Ring pass over disparity slabs (SURVEY.md §2.3 ring row, §5.7).

The dslab strategy (parallel/sharded.py) computes the level-0 cost
volume disparity-sharded, then pays ONE full `all_to_all` to reshard
spatial-major before the pyramid.  That reshard moves the whole volume
over the interconnect and requires every device to hold H0/K of the
FULL (H0, W0, D) volume — at KITTI scale with D >= 256 the resharded
slab plus pyramid transients grow with D (SURVEY.md §7 M3 memory
budget).

This strategy never reshards: the cost volume stays **D-sharded through
the entire pyramid** and only (H, W) *planes* ever cross devices:

  * level-0 correlation computes the local slab [k*Dl, (k+1)*Dl), as in
    dslab (ops/costvol.py d_offset);
  * each pyramid level's 3-wide disparity pool needs exactly ONE halo
    plane — the ring predecessor's last (odd) disparity plane — moved
    by neighbour `ppermute` (ring-attention-style neighbour exchange);
    `ops/pool.py:pool3_subsample(lo_pad=...)` then makes the slab-local
    pool bit-identical to the unsharded pool;
  * the top-level argmax is a **ring max/argmax all-reduce**: K-1
    `ppermute` steps each passing the accumulated (value, global-bin)
    pair to the ring successor, merged with the deterministic
    value-then-smallest-bin rule, so every chip ends with the exact
    first-max winner of the unsharded argmax;
  * top-down backtracking resolves each level's pool offset with a
    `psum`: the one slab owning a cell's current bin contributes its
    recorded offset, all others contribute 0 (models/pipeline.py
    backtrack reformulation, SURVEY.md §3.4).

Per level the ring moves one (H_l, W_l) f32 plane per direction and the
argmax/backtracking stages move K-1 + levels more — O(H*W) bytes total,
versus the dslab all_to_all's O(H*W*D/K).

Results are BITWISE equal to the unsharded pipeline
(tests/test_ringd.py): every cross-slab communication carries exact
values, every merge keeps the oracle's deterministic tie order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import Config, Geometry
from ..models import descriptors, pipeline
from ..ops import costvol as costvol_ops
from ..ops import pool as pool_ops


def _from_prev(x: jnp.ndarray, axis: str, n: int, fill) -> jnp.ndarray:
    """Ring-predecessor plane (slab k-1 -> k); slab 0 receives `fill`."""
    if n == 1:
        return jnp.full_like(x, fill)
    out = jax.lax.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])
    first = jax.lax.axis_index(axis) == 0
    return jnp.where(first, jnp.asarray(fill, x.dtype), out)


def _ring_argmax(val: jnp.ndarray, k: jnp.ndarray, axis: str, n: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ring all-reduce of (max value, tie -> smallest bin) pairs.

    Each of the K-1 steps forwards the accumulated pair to the ring
    successor and merges the received pair; max/min-tie merging is
    associative, commutative, and idempotent, so after K-1 steps every
    chip holds the reduction over all K slabs.  Ties pick the smaller
    global bin — slabs are ordered by disparity, so this is exactly the
    unsharded first-max (smallest d) rule of models/pipeline.py:backtrack.
    """
    perm = [(i, (i + 1) % n) for i in range(n)]
    for _ in range(n - 1):
        v_in = jax.lax.ppermute(val, axis, perm)
        k_in = jax.lax.ppermute(k, axis, perm)
        better = (v_in > val) | ((v_in == val) & (k_in < k))
        val = jnp.where(better, v_in, val)
        k = jnp.where(better, k_in, k)
    return val, k


def _ringd_direction(srcs: jnp.ndarray, tgts: jnp.ndarray, cfg: Config,
                     geom: Geometry, n_slab: int, reverse: bool
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched one-direction match with a D-sharded pyramid.

    srcs/tgts: (B_l, Hp, Wp) full padded images (replicated over the
    model axis).  Returns (disp_patch, score), each (B_l, H0, W0) and
    REPLICATED over the model axis (every slab finishes with the same
    global winner maps).
    """
    d_local = geom.disparities // n_slab
    ax = jax.lax.axis_index("model")
    d_lo = ax * d_local

    desc_src = jax.vmap(
        lambda x: descriptors.left_descriptors(x, cfg))(srcs)
    desc_tgt = jax.vmap(
        lambda x: descriptors.right_sliding_descriptors(x, cfg))(tgts)
    cost = jax.vmap(lambda s, t: costvol_ops.cost_volume(
        s, t, d_local, cfg.patch_size, cfg.max_disparity,
        reverse=reverse, d_offset=d_lo))(desc_src, desc_tgt)
    # D-MAJOR slab pyramid: the halo plane is a leading-axis slice.
    # Values are identical in either layout.
    cost = jnp.moveaxis(cost, -1, 1)            # (B_l, Dl, H0, W0)

    def per_pair(cost0):                        # (Dl, H0, W0)
        args = []
        cur = cost0
        for _ in range(geom.levels):
            halo = _from_prev(cur[cur.shape[0] - 1], "model", n_slab,
                              -1.0)
            sub, arg = pool_ops.pool3_subsample_dmajor(cur, lo_pad=halo)
            cur = pool_ops.aggregate_children_dmajor(sub, cfg.lam)
            args.append(arg)

        # Global top-level argmax via the ring reduce.
        n_top = cur.shape[0]
        k_loc = jnp.argmax(cur, axis=0).astype(jnp.int32) + ax * n_top
        v_loc = jnp.max(cur, axis=0)
        _, k = _ring_argmax(v_loc, k_loc, "model", n_slab)

        # Top-down: exactly one slab owns each cell's bin and supplies
        # the recorded pool offset; psum broadcasts it everywhere.
        for arg in reversed(args):
            n_loc = arg.shape[0]
            kr = jnp.repeat(jnp.repeat(k, 2, axis=0), 2, axis=1)
            k_rel = kr - ax * n_loc
            mine = (k_rel >= 0) & (k_rel < n_loc)
            off = pipeline._select_dmajor(
                arg.astype(jnp.int32), jnp.clip(k_rel, 0, n_loc - 1),
                jnp.int32)
            off = jax.lax.psum(jnp.where(mine, off, 0), "model")
            k = 2 * kr + off

        k_rel = k - d_lo
        mine = (k_rel >= 0) & (k_rel < d_local)
        sc = pipeline._select_dmajor(
            cost0, jnp.clip(k_rel, 0, d_local - 1), jnp.float32)
        sc = jax.lax.psum(jnp.where(mine, sc, 0.0), "model")
        return k, sc

    return jax.vmap(per_pair)(cost)


def match_batch_ringd(lefts_p: jnp.ndarray, rights_p: jnp.ndarray,
                      cfg: Config, height: int, width: int, mesh: Mesh,
                      debug_checks: bool = False
                      ) -> Dict[str, jnp.ndarray]:
    """Batched pipeline; cost volume D-sharded through the whole pyramid.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) padded pairs, replicated over
        "model" (pad with `pad_batch(..., strategy="ringd")` — same
        slab-aligned geometry as dslab).
      debug_checks: add an on-device checkify invariant asserting the
        winner maps really ARE replicated over the model axis — the
        property `check_vma=False` (below) stops the static checker
        from proving (SURVEY.md §5.2).  Callers must
        wrap with `checkify.checkify` when set.
    Returns dict of (B, height, width) outputs.
    """
    from . import sharded

    n_slab = mesh.shape["model"]
    _, local = sharded._slab_geometry(cfg, height, width, n_slab)
    p = cfg.patch_size

    def shard_fn(lp, rp):  # (B_l, Hp, Wp) replicated over model
        if cfg.lr_check and cfg.lr_mode == "flip":
            srcs = jnp.concatenate([lp, rp[:, :, ::-1]])
            tgts = jnp.concatenate([rp, lp[:, :, ::-1]])
            disp, score = _ringd_direction(srcs, tgts, cfg, local,
                                           n_slab, reverse=False)
            b = lp.shape[0]
            disp_fwd, disp_rev = disp[:b], disp[b:]
            score = score[:b]
            disp_r_patch = disp_rev[:, :, ::-1]  # patch-level flip
        elif cfg.lr_check:  # 'direct'
            disp_fwd, score = _ringd_direction(lp, rp, cfg, local,
                                               n_slab, reverse=False)
            disp_rev, _ = _ringd_direction(rp, lp, cfg, local,
                                           n_slab, reverse=True)
            disp_r_patch = disp_rev
        else:
            disp_fwd, score = _ringd_direction(lp, rp, cfg, local,
                                               n_slab, reverse=False)
            disp_r_patch = None

        disp_px = jax.vmap(lambda x: pipeline.densify(x, p))(disp_fwd)
        score_px = jax.vmap(lambda x: pipeline.densify(x, p))(score)
        valid = jnp.ones(disp_px.shape, dtype=bool)
        disp_r_px = jnp.zeros(disp_px.shape, dtype=jnp.int32)
        if cfg.lr_check:
            disp_r_px = jax.vmap(
                lambda x: pipeline.densify(x, p))(disp_r_patch)
            valid &= jax.vmap(
                lambda a, b_: pipeline.lr_consistency_patch(
                    a, b_, cfg.tau, local.disparities, p)
            )(disp_fwd, disp_r_patch)
        if cfg.min_score > 0.0:
            valid &= score_px >= cfg.min_score
        if debug_checks and n_slab > 1:
            # Replication invariant: every slab must hold the SAME
            # winner maps after the ring merges (compensates for
            # check_vma=False below — a future edit that breaks
            # replication fails here at runtime, not only in the
            # bitwise tests).  |x - ring_successor(x)| summed over all
            # slabs is 0 iff x is replicated.
            from jax.experimental import checkify

            perm = [(i, (i + 1) % n_slab) for i in range(n_slab)]
            for name_, x in (("disparity", disp_px), ("score", score_px)):
                nb = jax.lax.ppermute(x, "model", perm)
                resid = jax.lax.psum(
                    jnp.sum(jnp.abs((x - nb).astype(jnp.float32))),
                    "model")
                checkify.check(
                    resid == 0.0,
                    "ringd " + name_ + " not replicated over the model "
                    "axis (residual {r})", r=resid)
        out = jnp.where(valid, disp_px.astype(jnp.float32),
                        jnp.float32(cfg.invalid_value))
        return {
            "disparity": out,
            "disparity_raw": disp_px,
            "valid": valid,
            "score": score_px,
            "disparity_right": disp_r_px,
        }

    # check_vma=False: the ring-reduced winner maps ARE replicated over
    # the model axis (every slab runs the same merge to completion) but
    # the static varying-axes analysis cannot prove it through the
    # ppermute chain; correctness is asserted bitwise in
    # tests/test_ringd.py instead.
    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("data", None, None), P("data", None, None)),
        out_specs=P("data", None, None), check_vma=False)(lefts_p, rights_p)
    return pipeline.apply_postfilter(
        pipeline.crop(out, height, width), cfg)
