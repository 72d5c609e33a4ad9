"""Sharded end-to-end pipeline over a ("data", "model") mesh.

The reference has no parallelism of any kind (SURVEY.md §2.3); these are
the strategies that replace its single-process loops, built with
`shard_map` so every collective is explicit:

  * ``match_batch_tiled`` — DP over pairs + **spatial H-tile SP**: each
    model-shard owns a quadtree-aligned block of image rows and runs the
    ENTIRE pipeline locally with zero communication (see
    parallel/mesh.py for why aligned row-tiles need no halo).
  * ``match_batch_dslab`` — DP + **disparity-slab TP with a Ulysses-style
    reshard** (SURVEY.md §2.3 "ring attention/Ulysses analogue", §5.7):
    level-0 correlation (the FLOPs) is computed disparity-sharded —
    each shard builds cost-volume bins [k·Dl, (k+1)·Dl) for the full
    image — then ONE `all_to_all` over the model axis reshards
    spatial-major, and the pyramid/backtracking/LR stages run H-local.
    This is the layout for disparity ranges whose volume is too large
    for one device (SURVEY.md §7 M3).

Both return bitwise-identical results to the unsharded pipeline
(tests/test_sharded.py): tie-breaking is index-deterministic, reductions
keep fixed order, and tile/slab padding adds only zero descriptors /
zero-cost bins which can never win an argmax (ties pick the smallest
disparity).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import Config, Geometry
from ..models import descriptors, pipeline
from ..ops import costvol as costvol_ops
from . import mesh as mesh_lib
from . import wtiled


# ---------------------------------------------------------------------------
# Strategy 1: DP + spatial H-tiles (zero-communication SP)
# ---------------------------------------------------------------------------


def match_batch_tiled(lefts_p: jnp.ndarray, rights_p: jnp.ndarray,
                      cfg: Config, height: int, width: int, mesh: Mesh
                      ) -> Dict[str, jnp.ndarray]:
    """Batched pipeline, pairs over "data", H-tiles over "model".

    Args:
      lefts_p/rights_p: (B, Hp, Wp) pairs padded via `pad_batch` (Hp is
        the TILED padded height from mesh_lib.tiled_geometry).
    Returns dict of (B, height, width) outputs (same keys as
    models/pipeline.py:match_padded).
    """
    n_tile = mesh.shape["model"]
    _, local = mesh_lib.tiled_geometry(cfg, height, width, n_tile)

    def shard_fn(lp, rp):  # (B_local, Hp_local, Wp)
        return jax.vmap(
            lambda l, r: pipeline.match_padded_core(l, r, cfg, local)
        )(lp, rp)

    spec = P("data", "model", None)
    out = shard_map(shard_fn, mesh=mesh, in_specs=(spec, spec),
                    out_specs=spec)(lefts_p, rights_p)
    return pipeline.apply_postfilter(
        pipeline.crop(out, height, width), cfg)


# ---------------------------------------------------------------------------
# Strategy 2: DP + disparity-slab TP with Ulysses all_to_all reshard
# ---------------------------------------------------------------------------


def _slab_geometry(cfg: Config, height: int, width: int, n_slab: int
                   ) -> Tuple[Geometry, Geometry]:
    """Geometry with D padded to a slab multiple and H tile-aligned.

    Extra disparity bins (>= max_disparity) have cost 0 by construction
    (ops/costvol.py mask) and can never win an argmax, so padding D is
    bitwise-safe; H is padded exactly as for tiling because the pyramid
    runs H-sharded after the reshard.
    """
    glob, local = mesh_lib.tiled_geometry(cfg, height, width, n_slab)
    unit = n_slab * (cfg.subsample ** glob.levels)
    d0 = ((glob.disparities + unit - 1) // unit) * unit
    return (dataclasses.replace(glob, disparities=d0),
            dataclasses.replace(local, disparities=d0))


def _dslab_direction(srcs: jnp.ndarray, tgts: jnp.ndarray, cfg: Config,
                     geom: Geometry, n_slab: int, reverse: bool
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched one-direction match, disparity-sharded correlation.

    srcs/tgts: (B_l, Hp, Wp) FULL padded images (replicated over the
    model axis).  Returns (disp_patch, score), each (B_l, H0_local, W0)
    — H-sharded over the model axis after the internal all_to_all.
    """
    d_local = geom.disparities // n_slab
    d0 = jax.lax.axis_index("model") * d_local

    desc_src = jax.vmap(
        lambda x: descriptors.left_descriptors(x, cfg))(srcs)
    desc_tgt = jax.vmap(
        lambda x: descriptors.right_sliding_descriptors(x, cfg))(tgts)
    # Local disparity slab of the cost volume: (B_l, H0, W0, Dl),
    # re-laid D-MAJOR so the all_to_all concatenates along D.
    cost_slab = jax.vmap(lambda s, t: costvol_ops.cost_volume(
        s, t, d_local, cfg.patch_size, cfg.max_disparity,
        reverse=reverse, d_offset=d0))(desc_src, desc_tgt)
    cost_slab = jnp.moveaxis(cost_slab, -1, 1)    # (B_l, Dl, H0, W0)
    # Ulysses-style reshard: disparity-sharded -> spatial-sharded.
    cost = jax.lax.all_to_all(cost_slab, "model", split_axis=2,
                              concat_axis=1, tiled=True)
    # (B_l, D, H0/n, W0): pyramid + backtracking run H-local on the
    # D-major layout (bit-identical values, models/pipeline.py).
    return jax.vmap(
        lambda c: pipeline.match_dmajor_xla(c, geom.levels, cfg.lam)
    )(cost)


def match_batch_dslab(lefts_p: jnp.ndarray, rights_p: jnp.ndarray,
                      cfg: Config, height: int, width: int, mesh: Mesh
                      ) -> Dict[str, jnp.ndarray]:
    """Batched pipeline with disparity-slab-parallel correlation.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) padded pairs, replicated over
        "model" (pad with `pad_batch(..., strategy="dslab")`).
    Returns dict of (B, height, width) outputs.
    """
    n_slab = mesh.shape["model"]
    _, local = _slab_geometry(cfg, height, width, n_slab)
    p = cfg.patch_size

    def shard_fn(lp, rp):  # (B_l, Hp, Wp) replicated over model
        if cfg.lr_check and cfg.lr_mode == "flip":
            srcs = jnp.concatenate([lp, rp[:, :, ::-1]])
            tgts = jnp.concatenate([rp, lp[:, :, ::-1]])
            disp, score = _dslab_direction(srcs, tgts, cfg, local,
                                           n_slab, reverse=False)
            b = lp.shape[0]
            disp_fwd, disp_rev = disp[:b], disp[b:]
            score = score[:b]
            disp_r_patch = disp_rev[:, :, ::-1]  # patch-level flip
        elif cfg.lr_check:  # 'direct'
            disp_fwd, score = _dslab_direction(lp, rp, cfg, local,
                                               n_slab, reverse=False)
            disp_rev, _ = _dslab_direction(rp, lp, cfg, local,
                                           n_slab, reverse=True)
            disp_r_patch = disp_rev
        else:
            disp_fwd, score = _dslab_direction(lp, rp, cfg, local,
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
        out = jnp.where(valid, disp_px.astype(jnp.float32),
                        jnp.float32(cfg.invalid_value))
        return {
            "disparity": out,
            "disparity_raw": disp_px,
            "valid": valid,
            "score": score_px,
            "disparity_right": disp_r_px,
        }

    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("data", None, None), P("data", None, None)),
        out_specs=P("data", "model", None))(lefts_p, rights_p)
    return pipeline.apply_postfilter(
        pipeline.crop(out, height, width), cfg)


# ---------------------------------------------------------------------------
# Host-side batch prep + jitted wrappers
# ---------------------------------------------------------------------------


def strategy_geometry(cfg: Config, height: int, width: int, mesh: Mesh,
                      strategy: str = "tiled", merge_level=None
                      ) -> Geometry:
    """GLOBAL padded geometry required by the given sharded strategy
    (`merge_level` must match the value later passed to "wtiled" — it
    changes the W padding)."""
    if strategy == "wtiled":
        glob, _, _ = wtiled.tiled2d_geometry(
            cfg, height, width, mesh.shape["th"], mesh.shape["tw"],
            merge_level)
    elif strategy == "tiled":
        glob, _ = mesh_lib.tiled_geometry(cfg, height, width,
                                          mesh.shape["model"])
    elif strategy in ("dslab", "ringd"):
        glob, _ = _slab_geometry(cfg, height, width, mesh.shape["model"])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return glob


class PaddedPlane(np.ndarray):
    """Marker view: a float32 (Hp, Wp) plane ALREADY grayscale-normalised
    and padded to a strategy geometry (runner.pairs_from_paths emits
    these).  `pad_batch` copies marked planes through untouched; plain
    arrays always go through grayscale-normalisation — shape/dtype
    coincidence alone never bypasses it (an aligned-size float image
    in 8-bit range must not skip the /255)."""


def as_padded(plane) -> PaddedPlane:
    """Tag a pre-padded float32 plane for `pad_batch` pass-through."""
    a = np.ascontiguousarray(plane, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"pre-padded plane must be 2-D, got {a.shape}")
    return a.view(PaddedPlane)


def pad_batch(images, cfg: Config, height: int, width: int, mesh: Mesh,
              strategy: str = "tiled", merge_level=None):
    """Grayscale-normalise + pad a batch for the given sharded strategy.

    Returns a (B, Hp, Wp) float32 numpy array whose Hp/Wp satisfy the
    tile/slab alignment for `mesh`.  Inputs tagged with `as_padded`
    (see PaddedPlane) are copied through untouched; everything else is
    grayscale-normalised and zero-padded.
    """
    from ..oracle import reference as oracle

    glob = strategy_geometry(cfg, height, width, mesh, strategy,
                             merge_level)
    out = np.zeros((len(images), glob.padded_height, glob.padded_width),
                   dtype=np.float32)
    for i, img in enumerate(images):
        if isinstance(img, PaddedPlane):
            if img.shape != out.shape[1:]:
                raise ValueError(
                    f"pre-padded plane {img.shape} does not match the "
                    f"{strategy!r} padded geometry {out.shape[1:]}")
            out[i] = img
            continue
        g = oracle.to_grayscale_f32(img)
        out[i, : g.shape[0], : g.shape[1]] = g
    return out


def input_sharding(mesh: Mesh, strategy: str = "tiled") -> NamedSharding:
    """NamedSharding for (B, Hp, Wp) inputs of the given strategy."""
    if strategy == "wtiled":
        return NamedSharding(mesh, P("data", "th", "tw"))
    if strategy == "tiled":
        return NamedSharding(mesh, P("data", "model", None))
    return NamedSharding(mesh, P("data", None, None))


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width",
                                             "mesh", "strategy",
                                             "merge_level", "debug_checks"))
def match_batch_sharded(lefts_p, rights_p, cfg: Config, height: int,
                        width: int, mesh: Mesh, strategy: str = "tiled",
                        merge_level=None, debug_checks: bool = False):
    """Jitted entry: dispatches to a sharded pipeline strategy.

    `debug_checks` (ringd only) adds the on-device replication
    invariant; wrap the call with `checkify.checkify` when set."""
    if strategy == "tiled":
        return match_batch_tiled(lefts_p, rights_p, cfg, height, width,
                                 mesh)
    if strategy == "dslab":
        return match_batch_dslab(lefts_p, rights_p, cfg, height, width,
                                 mesh)
    if strategy == "ringd":
        from . import ringd
        return ringd.match_batch_ringd(lefts_p, rights_p, cfg, height,
                                       width, mesh, debug_checks)
    if strategy == "wtiled":
        return wtiled.match_batch_tiled2d(lefts_p, rights_p, cfg, height,
                                          width, mesh, merge_level)
    raise ValueError(f"unknown strategy {strategy!r}")
