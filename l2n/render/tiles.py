"""Shuffled round-robin tile scheduler.

The reference splits the image into 32x32 tiles, shuffles the tile list once
with a fixed-seed std::mt19937, and each frame dispatches
`tileCountPerIteration` workgroups starting at a wrap-around `tileOffset`
(l2n-renderer/src/main.cpp:830-852,926-927; consumed in-kernel at
sphere_pathtracing.cs.glsl:356-359). Same design here: the shuffled tile
array is a static (T, 2) int32 device constant per config; the offset is a
dynamic scalar in `FrameState`; the scheduled slice is computed inside jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def tile_grid(cfg) -> np.ndarray:
    """(T, 2) int32 of (tile_x, tile_y), row-major order shuffled once with
    a fixed-seed Mersenne Twister (main.cpp:836-848)."""
    tx, ty = np.meshgrid(np.arange(cfg.tile_count_x, dtype=np.int32),
                         np.arange(cfg.tile_count_y, dtype=np.int32))
    tiles = np.stack([tx.reshape(-1), ty.reshape(-1)], axis=1)
    gen = np.random.Generator(np.random.MT19937(cfg.tile_shuffle_seed))
    gen.shuffle(tiles, axis=0)
    return tiles


def scheduled_tiles(tile_array: jnp.ndarray, offset: jnp.ndarray,
                    count: int) -> jnp.ndarray:
    """The `count` tiles dispatched this step: tileArray[(i + offset) % T]
    (sphere_pathtracing.cs.glsl:356-357). Traced; offset is dynamic."""
    t = tile_array.shape[0]
    idx = (jnp.arange(count, dtype=jnp.int32) + offset) % jnp.int32(t)
    return tile_array[idx]


def scheduled_pixel_mask(cfg, tile_array: jnp.ndarray,
                         offset: jnp.ndarray, count: int,
                         height: int | None = None) -> jnp.ndarray:
    """(H, W) bool — True for pixels of tiles scheduled this step.

    Used by the full-frame XLA oracle backend, which computes every pixel
    and merges only scheduled ones (the Pallas backend instead touches only
    scheduled tiles, each program reading its tile from the schedule).
    `height` overrides the covered row count for slab-sharded use
    (tile_array then holds slab-local tile coordinates).
    """
    t = tile_array.shape[0]
    sched = scheduled_tiles(tile_array, offset, count)
    tile_ids = sched[:, 1] * jnp.int32(cfg.tile_count_x) + sched[:, 0]
    flags = jnp.zeros((max(t, 1),), jnp.bool_).at[tile_ids].set(True)
    py, px = jnp.meshgrid(jnp.arange(height or cfg.padded_height,
                                     dtype=jnp.int32),
                          jnp.arange(cfg.padded_width, dtype=jnp.int32),
                          indexing="ij")
    pixel_tile = ((py // jnp.int32(cfg.tile_height)) * jnp.int32(cfg.tile_count_x)
                  + px // jnp.int32(cfg.tile_width))
    return flags[pixel_tile]


def advance_offset(cfg, offset: jnp.ndarray) -> jnp.ndarray:
    """tileOffset = (tileOffset + tilesPerIteration) % tileCount
    (main.cpp:926-927)."""
    return ((offset + jnp.int32(cfg.effective_tiles_per_step))
            % jnp.int32(cfg.tile_count))
