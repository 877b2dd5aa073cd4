"""The jitted progressive render step.

One call = one of the reference's frame dispatches (`gpuRender`,
l2n-renderer/src/main.cpp:904-928): render `tiles_per_step` tiles from
the shuffled schedule, accumulate radiance, tonemap the touched pixels,
advance the tile cursor. Pure function of (FrameState, packed camera) with
the state donated, so accumulation stays resident in HBM across frames —
the analog of the reference's persistent GL textures.

Backends:
  * "xla"    — the full-frame vectorized oracle: every pixel is computed,
    only scheduled pixels merge. Runs anywhere; it is the correctness
    reference (the role of the reference's CPU renderer, main.cpp:206-599)
    and the renderer of triangle and OBJ scenes.
  * "pallas" — the fused sphere kernel over exactly the scheduled tiles
    (l2n.ops.kernels.sphere_pt), compiled through Triton for the GPU;
    `interpret=True` runs it in the Pallas interpreter instead.
  * "auto"   — `default_backend`: the kernel on a GPU, the oracle on CPU.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from l2n.config import RenderConfig
from l2n.ops.pathtrace import generate_rays, shade
from l2n.ops.scenes import (
    sphere_anyhit,
    sphere_intersector,
    triangle_intersector,
)
from l2n.render.state import FrameState
from l2n.render.tiles import scheduled_pixel_mask, tile_grid
from l2n.rng.sampler import (
    MaskedSampler,
    TausLCGSampler,
    ThreefrySampler,
    TinyMTSampler,
    max_pairs_per_sample,
)
from l2n.scene.spheres import SphereScene
from l2n.scene.tessellate import TriangleScene


def make_sampler(cfg: RenderConfig, state: FrameState, pixel_index,
                 sample_index, lane_mask):
    """Per-step sampler from config + frame state (see rng.sampler)."""
    if cfg.rng == "threefry":
        inner = ThreefrySampler(cfg.seed, 0, pixel_index, sample_index,
                                max_pairs_per_sample(cfg.max_bounces,
                                                     cfg.nee,
                                                     cfg.fog_density > 0))
    elif cfg.rng == "tinymt":
        words = tuple(state.rng_state[i] for i in range(7))
        inner = TinyMTSampler(words[:4], words[4:7])
    elif cfg.rng == "tauslcg":
        inner = TausLCGSampler(tuple(state.rng_state[i] for i in range(4)))
    else:  # pragma: no cover
        raise ValueError(cfg.rng)
    return MaskedSampler(inner, lane_mask)


def global_sample_index(local_index, sample_rank, sample_stride: int):
    """Sample number a replica draws for its `local_index`-th sample.
    Sample-axis replicas interleave one numbering (replica r of n takes
    local * n + r), so n replicas of spp samples draw exactly the samples
    one device draws at n * spp — sharding does not change the picture."""
    if sample_stride == 1:
        return local_index
    return (local_index * jnp.uint32(sample_stride)
            + jnp.asarray(sample_rank).astype(jnp.uint32))


def merge_rng_state(cfg: RenderConfig, state: FrameState, sampler,
                    lane_mask) -> jnp.ndarray | None:
    """Fold the sampler's stepped per-pixel states back into the frame state
    for scheduled lanes (stateful parity modes only)."""
    if not sampler.stateful:
        return state.rng_state
    final = sampler.final_state()
    if cfg.rng == "tinymt":
        new = jnp.stack(final + tuple(state.rng_state[4:]), axis=0)
    else:
        new = jnp.stack(final, axis=0)
    return jnp.where(lane_mask[None], new, state.rng_state)


def _xla_step(cfg: RenderConfig, intersect, miss_color, tile_array,
              state: FrameState, camera: jnp.ndarray,
              row_offset=0, sample_rank=0, sample_stride=1,
              light_sampler=None, intersect_anyhit=None,
              lights=None) -> FrameState:
    """One full-frame oracle step. `row_offset` and the sample arguments
    support multi-device sharding: the state covers rows [row_offset,
    row_offset + h) of the global framebuffer, and replica `sample_rank` of
    `sample_stride` draws the interleaved global sample numbers
    count * stride + rank (see `global_sample_index`)."""
    h, w = state.accum.shape[1], cfg.padded_width
    k = cfg.effective_tiles_per_step
    mask = scheduled_pixel_mask(cfg, tile_array, state.tile_offset, k,
                                height=h)

    py, px = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32) + row_offset,
                          jnp.arange(w, dtype=jnp.int32), indexing="ij")
    # pixelIndex = x + y * width (sphere_pathtracing.cs.glsl:365), over the
    # padded global grid so all backends/shardings key RNG identically.
    pixel_index = (px + py * jnp.int32(w)).astype(jnp.uint32)
    sample_index = state.accum[3].astype(jnp.int32).astype(jnp.uint32)

    spp = cfg.spp_per_step
    sum_r = sum_g = sum_b = jnp.zeros((h, w), jnp.float32)
    work = state
    for s in range(spp):
        sampler = make_sampler(
            cfg, work, pixel_index,
            global_sample_index(sample_index + jnp.uint32(s), sample_rank,
                                sample_stride), mask)
        u1, u2 = sampler.draw2()  # pixel jitter (glsl:371)
        rays = generate_rays(cfg, camera, px.astype(jnp.float32),
                             py.astype(jnp.float32), u1, u2)
        r, g, b = shade(cfg, intersect, sampler, *rays, miss_color=miss_color,
                        intersect_anyhit=intersect_anyhit,
                        light_sampler=light_sampler, lights=lights)
        sum_r, sum_g, sum_b = sum_r + r, sum_g + g, sum_b + b
        work = dataclasses.replace(
            work, rng_state=merge_rng_state(cfg, work, sampler, mask))

    # newEstimate = current + (color_sum, spp); display = pow(rgb/n, gamma)
    # (glsl:391-395), merged only for scheduled pixels.
    rgb1 = jnp.stack([sum_r, sum_g, sum_b,
                      jnp.full((h, w), float(spp), jnp.float32)], axis=0)
    accum = jnp.where(mask[None], state.accum + rgb1, state.accum)
    display = jnp.power(
        jnp.maximum(accum[:3], 0.0)
        / jnp.maximum(accum[3:4], jnp.float32(1e-20)),
        jnp.float32(cfg.gamma))
    output = jnp.where(mask[None], display, state.output)

    return FrameState(
        accum=accum,
        output=output,
        tile_offset=(state.tile_offset + jnp.int32(k))
        % jnp.int32(tile_array.shape[0]),
        iteration=state.iteration + 1,
        rng_state=work.rng_state,
    )


def make_intersector(cfg: RenderConfig, scene):
    """(intersect closure, AOV miss color, light sampler or None, any-hit
    closure or None) for a scene pytree."""
    if cfg.scene_kind == "sphere":
        if not isinstance(scene, SphereScene):
            raise TypeError("sphere config needs a SphereScene")
        light_sampler = None
        if cfg.nee:
            from l2n.ops.nee import make_sphere_light_sampler
            # Scene buffers are host numpy; lift once — the sampler fetches
            # with a traced light index.
            cx, cy, cz, r2 = (jnp.asarray(scene.center_x),
                              jnp.asarray(scene.center_y),
                              jnp.asarray(scene.center_z),
                              jnp.asarray(scene.sqr_radius))
            light_sampler = make_sphere_light_sampler(
                scene.count, cfg.emissive_every,
                lambda i: (cx[i], cy[i], cz[i], r2[i]))
        # sphere normal AOV misses to black (glsl:350)
        return (sphere_intersector(scene, fast_math=cfg.fast_math),
                (0.0, 0.0, 0.0), light_sampler, sphere_anyhit(scene))
    if not isinstance(scene, TriangleScene):
        raise TypeError("triangle config needs a TriangleScene")
    light_sampler = None
    bound_r2 = None
    if cfg.nee:
        # Cone NEE over the emissive meshes' bounding spheres.
        from l2n.ops.nee import make_mesh_light_sampler
        from l2n.scene.tessellate import mesh_bounds
        bounds_np = mesh_bounds(scene)
        bx = jnp.asarray(bounds_np[:, 0])
        by = jnp.asarray(bounds_np[:, 1])
        bz = jnp.asarray(bounds_np[:, 2])
        br2 = jnp.asarray(bounds_np[:, 3])
        light_sampler = make_mesh_light_sampler(
            scene.mesh_count, cfg.emissive_every,
            lambda m: (bx[m], by[m], bz[m], br2[m]))
        bound_r2 = br2
    # triangle AOVs miss to magenta (triangle_pathtracing.cs.glsl:340)
    return (triangle_intersector(scene.soup(), bound_r2=bound_r2),
            (1.0, 0.0, 1.0), light_sampler, None)


def default_backend(cfg: RenderConfig) -> str:
    """What backend="auto" means on this process's JAX platform: the fused
    kernel for sphere scenes on a GPU, the oracle otherwise on a GPU and
    everywhere on CPU. Any other platform is an error, not a fallback."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas" if cfg.scene_kind == "sphere" else "xla"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no render backend for JAX platform {platform!r}")


def build_render_step(cfg: RenderConfig, scene, backend: str = "xla",
                      donate: bool = True, steps_per_call: int = 1,
                      lights=None, interpret: bool = False):
    """Compile a render step for (config, scene).

    scene: SphereScene or TriangleScene per cfg.scene_kind.
    Returns step(state, packed_camera) -> state (jitted; state donated so
    accumulation never leaves device memory). `steps_per_call` fuses N
    scheduler steps into each call via lax.fori_loop — identical results,
    one dispatch. `lights` (ops.lights.ExplicitLights, optional): live
    material/light buffers; None or all-empty compiles the identical
    program. `interpret=True` runs the "pallas" kernel in the Pallas
    interpreter (tests on CPU); it is never chosen implicitly.
    """
    cfg.validate()
    if lights is not None and not lights.enabled:
        lights = None
    if backend == "auto":
        backend = default_backend(cfg)
    tile_array = tile_grid(cfg)

    if backend == "xla":
        intersect, miss_color, light_sampler, anyhit = make_intersector(
            cfg, scene)
        # Lift: the schedule is gathered with a traced offset.
        tile_array = jnp.asarray(tile_array)
        fn = partial(_xla_step, cfg, intersect, miss_color, tile_array,
                     light_sampler=light_sampler, intersect_anyhit=anyhit,
                     lights=lights)
        if steps_per_call > 1:
            inner = fn
            fn = lambda state, camera: jax.lax.fori_loop(
                0, steps_per_call, lambda _, st: inner(st, camera), state)
        return jax.jit(fn, donate_argnums=(0,) if donate else ())
    if backend == "pallas":
        if cfg.scene_kind != "sphere":
            raise ValueError("the pallas kernel renders sphere scenes only; "
                             "triangle scenes use backend='xla'")
        if not isinstance(scene, SphereScene):
            raise TypeError("sphere config needs a SphereScene")
        from l2n.ops.kernels.sphere_pt import build_sphere_step
        return build_sphere_step(cfg, scene, tile_array, donate=donate,
                                 steps_per_call=steps_per_call,
                                 lights=lights, interpret=interpret)
    raise ValueError(f"unknown backend {backend!r}")
