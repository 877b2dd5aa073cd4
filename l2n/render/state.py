"""Functional frame state.

Everything the reference mutates across frames, as one pytree:
  * `accum`  — accumulation planes: rgb = sum of radiance samples, plane 3 =
    per-pixel sample count (the GL RGBA32F accum texture, src/main.cpp:
    880-886, updated at sphere_pathtracing.cs.glsl:391-395);
  * `output` — the tonemapped display planes (uOutputImage); like the
    reference it is only rewritten for tiles rendered this step;
  * `tile_offset` — the wrap-around scheduler cursor (main.cpp:903,926-927);
  * `iteration` — frame counter (uIterationCount);
  * `rng_state` — packed per-pixel RNG states for the stateful parity modes
    (the resident TinyMT buffer, main.cpp:859-878); None under threefry,
    whose "state" is just the per-pixel sample count already in accum[3].

Layout: images are CHANNEL-MAJOR planes (C, H, W), padded so the tile grid
divides them exactly; a kernel block then loads each plane's rows as
contiguous runs. Pad pixels are rendered (they are the analog of the
reference's bounds-guarded threads, glsl:361-363) and cropped at display
time.

Clear-on-move / clear-on-switch semantics: `clear_accumulation` zeroes only
the accumulation — not the output (stale pixels keep displaying until
re-rendered), not the tile offset, not the RNG states — exactly
`clearFramebuffer` (main.cpp:944-948).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp

from l2n.rng.state import init_tauslcg_states, init_tinymt_states


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameState:
    accum: jnp.ndarray            # (4, Hp, Wp) f32
    output: jnp.ndarray           # (3, Hp, Wp) f32
    tile_offset: jnp.ndarray      # () i32
    iteration: jnp.ndarray        # () i32
    rng_state: jnp.ndarray | None  # (8, Hp, Wp) u32 (tinymt) | (4, Hp, Wp) u32 | None


def init_frame_state(cfg) -> FrameState:
    h, w = cfg.padded_height, cfg.padded_width
    rng_state = None
    if cfg.rng == "tinymt":
        status, params = init_tinymt_states(h, w, cfg.seed)
        words = status + tuple(jnp.broadcast_to(p, (h, w)) for p in params)
        rng_state = jnp.stack(words + (jnp.zeros((h, w), jnp.uint32),), axis=0)
    elif cfg.rng == "tauslcg":
        rng_state = jnp.stack(init_tauslcg_states(h, w, cfg.seed), axis=0)
    return FrameState(
        accum=jnp.zeros((4, h, w), jnp.float32),
        output=jnp.zeros((3, h, w), jnp.float32),
        tile_offset=jnp.int32(0),
        iteration=jnp.int32(0),
        rng_state=rng_state,
    )


def clear_accumulation(state: FrameState) -> FrameState:
    """clearFramebuffer (main.cpp:944-948): accumulation only."""
    return dataclasses.replace(state, accum=jnp.zeros_like(state.accum))


def samples_per_pixel(cfg, state: FrameState) -> np.ndarray:
    """(H, W) sample counts, cropped to the visible image."""
    return np.asarray(state.accum[3, :cfg.height, :cfg.width])


def display_image(cfg, state: FrameState) -> np.ndarray:
    """(H, W, 3) float32 tonemapped image, cropped to the visible area."""
    return np.moveaxis(
        np.asarray(state.output[:, :cfg.height, :cfg.width]), 0, -1)
