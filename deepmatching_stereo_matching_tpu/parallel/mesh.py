"""Device-mesh construction and tile-aligned geometry (SURVEY.md §2.4, §5.8).

The reference is single-process CPU NumPy with no communication layer
(SURVEY.md §2.3/§2.4) — this framework replaces that absence with XLA
collectives over a `jax.sharding.Mesh`.  Axes:

  * ``data``  — batch of stereo pairs (DP; SURVEY.md §2.3 row 1).
  * ``model`` — the intra-pair axis, used as *spatial H-tiles* during the
    pyramid/selection stages and as *disparity slabs* during level-0
    correlation (TP analogue; SURVEY.md §2.3 rows 2/4 and §5.7).

Spatial decomposition is over image ROWS: the DeepMatching pipeline on
rectified pairs is row-block-local (correlation targets stay on the
scanline; quadtree aggregation couples rows only within blocks of
``patch_size * 2**levels`` pixels; the LR check gathers along x only),
so H-tiles aligned to that block size need NO halo at all.  W-tiling,
which needs D-pixel halos, is deliberately second choice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from ..config import Config, Geometry


def make_mesh(n_data: int, n_model: int,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ("data", "model") mesh from the first n_data*n_model devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_model
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a ({n_data}, {n_model}) mesh, "
            f"have {len(devices)}")
    grid = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def make_mesh2d(n_data: int, n_th: int, n_tw: int,
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """("data", "th", "tw") mesh for the 2-D spatial tile strategy.

    ``tw`` is the halo-exchange axis (parallel/wtiled.py).  Devices are
    taken in `jax.devices()` order; on cards joined all to all (NVLink)
    every neighbour pair is one hop, so the axis order follows the
    algorithm, not the wiring.
    """
    if devices is None:
        devices = jax.devices()
    need = n_data * n_th * n_tw
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a ({n_data}, {n_th}, {n_tw}) mesh, "
            f"have {len(devices)}")
    grid = np.asarray(devices[:need]).reshape(n_data, n_th, n_tw)
    return Mesh(grid, ("data", "th", "tw"))


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Default mesh over n devices: data axis 2 if possible, rest model."""
    n = n_devices if n_devices is not None else len(jax.devices())
    n_data = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh(n_data, n // n_data)


def tiled_geometry(cfg: Config, height: int, width: int,
                   n_tiles: int) -> Tuple[Geometry, Geometry]:
    """(global, per-tile) geometry with H padded so tiles stay aligned.

    The global padded height is rounded up to a multiple of
    ``n_tiles * patch_size * 2**levels`` so each tile owns whole quadtree
    row-blocks; the extra all-zero rows produce zero descriptors and
    therefore never change the cropped result (zero correlates to zero,
    exactly the unsharded padding rule in oracle/reference.py:pad_image).
    """
    g = cfg.geometry(height, width)
    block = cfg.patch_size * (cfg.subsample ** g.levels)
    unit = block * n_tiles
    hp = ((g.padded_height + unit - 1) // unit) * unit
    glob = dataclasses.replace(
        g, padded_height=hp, grid_h=hp // cfg.patch_size)
    local = dataclasses.replace(
        glob,
        padded_height=hp // n_tiles,
        grid_h=hp // n_tiles // cfg.patch_size,
        height=hp // n_tiles,
    )
    return glob, local
