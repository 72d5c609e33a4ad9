"""2-D spatial tile sharding with `ppermute` halo exchange (SURVEY.md §5.7).

The reference is a single-process CPU script (SURVEY.md §2.3); its
replacement must scale the image plane over devices.  `sharded.py`'s
H-tiles are zero-communication but cap the model axis at
``H / (patch * 2**levels)`` tiles; this module adds the halo-exchange
axes mandated by BASELINE.json:5 ("partitioning image tiles ... with
halo exchange and pyramid-level reductions over collectives"):

  * **W-tiles** over a ``tw`` mesh axis.  Disparity search is along x,
    so each tile needs a halo of ``ceil(D/p)`` patch columns of the
    *target* image on each side — exchanged once per image as raw pixel
    columns via neighbour `ppermute` (ring-attention-style neighbour
    exchange, SURVEY.md §5.7), then turned into sliding descriptors
    locally with exact global-coordinate masking
    (models/descriptors.py:sliding_descriptors).
  * **H-tiles** over a ``th`` mesh axis, composing with W-tiles into a
    2-D spatial decomposition.  Rows only couple through the gradient
    operator of 'grad_hist' descriptors, handled by a 1-row `ppermute`
    halo (the pure H-tiled strategy in sharded.py skips this and is
    therefore exact only for 'patch' descriptors).
  * **Coarse pyramid merges**: quadtree aggregation couples patch
    columns within blocks of ``2**l``.  Tiles are aligned to
    ``p * 2**l0`` pixels; levels <= l0 run tile-local, and — when
    ``l0 < levels`` — the level-l0 maps are merged full-width with ONE
    `all_gather` over ``tw``, the (tiny) coarse levels run replicated,
    and backtracking descends replicated to level l0 where each tile
    slices its span and continues locally.  This removes the alignment
    cap on tile count at the cost of one small collective.
  * The **LR consistency** gather ``dR[x - dL]`` crosses tile
    boundaries (SURVEY.md §3.5); the W-neighbour's trailing patch
    columns are `ppermute`d in and fed to the pre-padded LR core
    (models/pipeline.py:lr_consistency_patch_padded).
  * ``lr_mode='flip'`` needs a global horizontal image flip, which on a
    W-sharded array is a local reverse + a mirror `ppermute`
    (tile i -> tile n-1-i) — so BOTH lr modes shard bitwise.

Every output is bit-identical to the unsharded pipeline
(tests/test_wtiled.py): halo descriptors are built from the same f32
pixels with the same ops, out-of-image windows are zeroed exactly as in
the unsharded rule, and the replicated coarse levels consume an
`all_gather` concatenation that reproduces the unsharded maps bitwise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import Config, Geometry
from ..models import descriptors, pipeline
from ..ops import costvol as costvol_ops


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def tiled2d_geometry(cfg: Config, height: int, width: int, n_th: int,
                     n_tw: int, merge_level: Optional[int] = None
                     ) -> Tuple[Geometry, Geometry, int]:
    """(global, per-tile, l0) geometry for an (n_th, n_tw) tile grid.

    Heights are padded to a multiple of ``n_th * p * 2**L`` (whole
    quadtree row-blocks per H-tile, as in mesh.tiled_geometry); widths
    to ``lcm(p * 2**L, n_tw * p * 2**l0)`` so the global pyramid is
    well-formed and each W-tile owns whole level-l0 blocks.  ``l0`` is
    the deepest tile-local pyramid level: ``levels`` when
    ``merge_level`` is None (zero pyramid communication), else
    ``min(merge_level, levels)`` (coarser levels are merged with one
    `all_gather`, trading a small collective for much less padding when
    n_tw is large).
    """
    g = cfg.geometry(height, width)
    lvl = g.levels
    l0 = lvl if merge_level is None else max(0, min(merge_level, lvl))
    p = cfg.patch_size
    s = cfg.subsample
    unit_h = n_th * p * (s ** lvl)
    hp = -(-g.padded_height // unit_h) * unit_h
    unit_w = math.lcm(p * (s ** lvl), n_tw * p * (s ** l0))
    wp = -(-g.padded_width // unit_w) * unit_w
    glob = dataclasses.replace(g, padded_height=hp, padded_width=wp,
                               grid_h=hp // p, grid_w=wp // p)
    local = dataclasses.replace(
        glob,
        padded_height=hp // n_th, grid_h=hp // n_th // p,
        height=hp // n_th,
        padded_width=wp // n_tw, grid_w=wp // n_tw // p,
        width=wp // n_tw)
    return glob, local, l0


def halo_patches(cfg: Config) -> int:
    """Target-descriptor halo width in patch columns: ceil(D / p).

    The forward direction reads target columns down to ``p*j - (D-1)``
    and the reverse up to ``p*j + (D-1) + (p-1)`` (sliding-window
    extent), both within ``ceil(D/p) * p`` pixels of the tile (the LR
    check's halo needs one patch column more; see
    `match_batch_tiled2d`).
    """
    return -(-cfg.max_disparity // cfg.patch_size)


# ---------------------------------------------------------------------------
# Neighbour exchange primitives (ppermute; zeros at the grid boundary)
# ---------------------------------------------------------------------------


def _from_prev(x: jnp.ndarray, axis_name: str, n: int, width: int,
               axis: int) -> jnp.ndarray:
    """Each shard receives the PREVIOUS shard's trailing `width` slice.

    The first shard (no previous neighbour) receives zeros — `ppermute`
    semantics for absent senders, which is exactly the out-of-image
    fill the masking layers expect.
    """
    size = x.shape[axis]
    sl = jax.lax.slice_in_dim(x, size - width, size, 1, axis)
    return jax.lax.ppermute(sl, axis_name,
                            [(i, i + 1) for i in range(n - 1)])


def _from_next(x: jnp.ndarray, axis_name: str, n: int, width: int,
               axis: int) -> jnp.ndarray:
    """Each shard receives the NEXT shard's leading `width` slice."""
    sl = jax.lax.slice_in_dim(x, 0, width, 1, axis)
    return jax.lax.ppermute(sl, axis_name,
                            [(i + 1, i) for i in range(n - 1)])


def _extend(x: jnp.ndarray, axis_name: str, n: int, width: int,
            axis: int) -> jnp.ndarray:
    """Concatenate [prev-halo, x, next-halo] along `axis`."""
    if width == 0:
        return x
    return jnp.concatenate(
        [_from_prev(x, axis_name, n, width, axis), x,
         _from_next(x, axis_name, n, width, axis)], axis=axis)


def _mirror(x: jnp.ndarray, axis_name: str, n: int, axis: int
            ) -> jnp.ndarray:
    """Global reverse of a sharded axis: local flip + mirror ppermute."""
    rev = jnp.flip(x, axis)
    if n == 1:
        return rev
    return jax.lax.ppermute(rev, axis_name,
                            [(i, n - 1 - i) for i in range(n)])


# ---------------------------------------------------------------------------
# Halo-exact pixel features
# ---------------------------------------------------------------------------


def _features_slab(slab: jnp.ndarray, cfg: Config, row0, col0,
                   hg: int, wg: int, halo_px: int, mr: int
                   ) -> jnp.ndarray:
    """Pixel features of a halo-extended image slab, bit-equal to global.

    Args:
      slab: (Hl + 2*mr, Wl + 2*(halo_px + mc)) image columns, mc = 1 in
        'grad_hist' mode (one extra gradient-margin pixel per side),
        0 in 'patch' mode.
      row0/col0: GLOBAL coordinates of the returned block's [0, 0] pixel
        (col0 = tile_start - halo_px; both may be traced).
      hg/wg: global padded image extents.
      mr: row margin (1 when 'grad_hist' rows are sharded over th).

    Returns (Hl, Wl + 2*halo_px, F).  Entries whose global column lies
    outside the image are garbage (boundary tiles receive zero halos)
    and MUST be masked downstream — `sliding_descriptors`' global-window
    mask does exactly that; in-image entries are bit-identical to the
    unsharded `pixel_features` because interior pixels use the same
    central differences on the same f32 values and pixels on the global
    image border get the same one-sided formula via the xg/rg overrides.
    """
    if cfg.descriptor == "patch":
        return slab[..., None]  # mc = mr = 0: already the output extent

    # grad_hist: x-gradient on core rows over all but the margin columns.
    hs, ws = slab.shape
    core_rows = slab[mr: hs - mr] if mr else slab
    left, mid, right = core_rows[:, :-2], core_rows[:, 1:-1], core_rows[:, 2:]
    gx = (right - left) * jnp.float32(0.5)
    xg = jnp.asarray(col0, jnp.int32) + jnp.arange(ws - 2, dtype=jnp.int32)
    gx = jnp.where((xg == 0)[None, :], right - mid, gx)
    gx = jnp.where((xg == wg - 1)[None, :], mid - left, gx)

    if mr:
        up, vmid, down = slab[:-2], slab[1:-1], slab[2:]
        gy = (down - up) * jnp.float32(0.5)
        rg = jnp.asarray(row0, jnp.int32) + jnp.arange(
            hs - 2, dtype=jnp.int32)
        gy = jnp.where((rg == 0)[:, None], down - vmid, gy)
        gy = jnp.where((rg == hg - 1)[:, None], vmid - up, gy)
        gy = gy[:, 1:-1]
    else:
        # Tile spans the full image height: np.gradient edge semantics
        # of _gradient_1d are already the global ones.
        gy = descriptors._gradient_1d(slab, 0)[:, 1:-1]
    return descriptors.hist_from_gradients(gx, gy)


# ---------------------------------------------------------------------------
# Per-tile matching (cost volume -> pyramid -> backtracking)
# ---------------------------------------------------------------------------


def _match_tile(desc_src: jnp.ndarray, desc_tgt: jnp.ndarray, cfg: Config,
                local: Geometry, l0: int, halo_q: int, reverse: bool
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One direction on a tile: halo-extended targets, optional merge.

    When l0 == levels the whole pyramid is tile-local and runs
    unchanged via `match_from_descriptors`.  Otherwise levels <= l0
    run tile-local, ONE `all_gather` over ``tw`` merges the level-l0
    maps full-width (the "pyramid-level reductions over collectives"
    of BASELINE.json:5), the replicated coarse
    levels + top argmax run on every tile identically, and backtracking
    re-enters the tile at level l0 via a dynamic slice.
    """
    if l0 == local.levels:
        return pipeline.match_from_descriptors(
            desc_src, desc_tgt, cfg, local, reverse=reverse,
            origin_offset=halo_q)

    cost0 = costvol_ops.cost_volume(
        desc_src, desc_tgt, local.disparities, cfg.patch_size,
        cfg.max_disparity, reverse=reverse, origin_offset=halo_q)
    maps, args = pipeline.build_pyramid(cost0, l0, cfg.lam)
    top_full = jax.lax.all_gather(maps[l0], "tw", axis=1, tiled=True)
    cmaps, cargs = pipeline.build_pyramid(
        top_full, local.levels - l0, cfg.lam)
    k = jnp.argmax(cmaps[-1], axis=-1).astype(jnp.int32)
    k = pipeline.backtrack_from(k, cargs)  # level l0, full W, replicated
    w_l0 = local.grid_w >> l0
    tw = jax.lax.axis_index("tw")
    k = jax.lax.dynamic_slice(k, (jnp.int32(0), tw * w_l0),
                              (k.shape[0], w_l0))
    k = pipeline.backtrack_from(k, args)
    score = pipeline._select_at(maps[0], k, jnp.float32)
    return k, score


# ---------------------------------------------------------------------------
# Strategy entry point
# ---------------------------------------------------------------------------


def match_batch_tiled2d(lefts_p: jnp.ndarray, rights_p: jnp.ndarray,
                        cfg: Config, height: int, width: int, mesh: Mesh,
                        merge_level: Optional[int] = None
                        ) -> Dict[str, jnp.ndarray]:
    """Batched pipeline over a ("data", "th", "tw") mesh.

    Args:
      lefts_p/rights_p: (B, Hp, Wp) pairs padded via
        `sharded.pad_batch(..., strategy="wtiled")`.
    Returns dict of (B, height, width) outputs (same keys as
    models/pipeline.py:match_padded).
    """
    n_th = mesh.shape["th"]
    n_tw = mesh.shape["tw"]
    glob, local, l0 = tiled2d_geometry(cfg, height, width, n_th, n_tw,
                                       merge_level)
    p = cfg.patch_size
    halo_q = halo_patches(cfg)
    halo_px = halo_q * p
    mc = 1 if cfg.descriptor == "grad_hist" else 0
    mr = 1 if (cfg.descriptor == "grad_hist" and n_th > 1) else 0
    hl, wl = local.padded_height, local.padded_width
    w0l, h0l = local.grid_w, local.grid_h
    n_q = -(-local.disparities // p)  # LR-halo patch columns (padded D)
    if halo_px + mc > wl:
        raise ValueError(
            f"W-tile width {wl} px cannot carry a {halo_px + mc} px halo "
            f"(max_disparity={cfg.max_disparity}); use fewer W-tiles")
    if cfg.lr_check and n_q + 1 > w0l:
        raise ValueError(
            f"W-tile width {w0l} patches cannot carry the LR halo of "
            f"{n_q + 1} patch columns; use fewer W-tiles")
    sentinel = jnp.iinfo(jnp.int32).min // 2

    def exchange(x):  # (B', Hl, Wl) -> (B', Hl + 2mr, Wl + 2(halo_px+mc))
        if mr:
            x = _extend(x, "th", n_th, mr, axis=1)
        return _extend(x, "tw", n_tw, halo_px + mc, axis=2)

    def per_pair(src_slab, tgt_slab, reverse):
        th = jax.lax.axis_index("th")
        tw = jax.lax.axis_index("tw")
        row0 = th * hl
        col0 = tw * wl - halo_px
        feat_s = _features_slab(src_slab, cfg, row0, col0,
                                glob.padded_height, glob.padded_width,
                                halo_px, mr)
        feat_t = _features_slab(tgt_slab, cfg, row0, col0,
                                glob.padded_height, glob.padded_width,
                                halo_px, mr)
        desc_src = descriptors.patch_descriptors(
            feat_s[:, halo_px: halo_px + wl], cfg)
        desc_tgt = descriptors.sliding_descriptors(
            feat_t, cfg, col0=col0, width_global=glob.padded_width)
        return _match_tile(desc_src, desc_tgt, cfg, local, l0, halo_q,
                           reverse)

    fwd = functools.partial(per_pair, reverse=False)

    def shard_fn(lp, rp):  # (B_l, Hl, Wl)
        if cfg.lr_check and cfg.lr_mode == "flip":
            # Global flip on a W-sharded array = local flip + mirror
            # ppermute; both directions then share ONE forward vmap.
            srcs = jnp.concatenate([lp, _mirror(rp, "tw", n_tw, 2)])
            tgts = jnp.concatenate([rp, _mirror(lp, "tw", n_tw, 2)])
            disp, score = jax.vmap(fwd)(exchange(srcs), exchange(tgts))
            b = lp.shape[0]
            disp_fwd, disp_rev = disp[:b], disp[b:]
            score = score[:b]
            disp_r_patch = _mirror(disp_rev, "tw", n_tw, 2)
        elif cfg.lr_check:  # 'direct'
            ls, rs = exchange(lp), exchange(rp)
            disp_fwd, score = jax.vmap(fwd)(ls, rs)
            disp_r_patch, _ = jax.vmap(
                functools.partial(per_pair, reverse=True))(rs, ls)
        else:
            disp_fwd, score = jax.vmap(fwd)(exchange(lp), exchange(rp))
            disp_r_patch = None

        dens = jax.vmap(lambda x: pipeline.densify(x, p))
        disp_px = dens(disp_fwd)
        score_px = dens(score)
        valid = jnp.ones(disp_px.shape, dtype=bool)
        disp_r_px = jnp.zeros(disp_px.shape, dtype=jnp.int32)
        if cfg.lr_check:
            disp_r_px = dens(disp_r_patch)
            # The dR[x - dL] gather reaches across the tile's left edge:
            # ppermute the neighbour's trailing n_q+1 patch columns in
            # (sentinel out-of-image fill at the first tile).
            halo = _from_prev(disp_r_patch, "tw", n_tw, n_q + 1, axis=2)
            first = jax.lax.axis_index("tw") == 0
            halo = jnp.where(first, jnp.int32(sentinel), halo)
            padded = jnp.concatenate([halo, disp_r_patch], axis=2)
            col0_patches = jax.lax.axis_index("tw") * w0l
            valid &= jax.vmap(
                lambda a, b_: pipeline.lr_consistency_patch_padded(
                    a, b_, cfg.tau, local.disparities, p, col0_patches)
            )(disp_fwd, padded)
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

    spec = P("data", "th", "tw")
    out = shard_map(shard_fn, mesh=mesh, in_specs=(spec, spec),
                    out_specs=spec)(lefts_p, rights_p)
    return pipeline.apply_postfilter(
        pipeline.crop(out, height, width), cfg)
