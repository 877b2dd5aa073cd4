"""Fused sphere path-tracing kernel for NVIDIA GPUs (Pallas, Triton route).

Rebuild of the reference's per-pixel megakernel
(l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl): one Pallas
program per (scheduled tile, pixel sub-block) runs the whole pipeline with
the path state in registers:

  tile lookup (schedule read in-kernel)   <-  glsl:356-359
  per-pixel RNG                           <-  glsl:367 (threefry default)
  jittered primary ray                    <-  glsl:371-384
  masked bounce loop over the spheres     <-  glsl:272-317
  accumulate + gamma display              <-  glsl:391-395

The framebuffer planes stay whole-array operands in device memory; each
program loads its tile origin from the schedule itself, reads and writes
its own sub-block in place (the accumulation/output/RNG planes are aliased
input->output, so pixels of unscheduled tiles keep their contents). The
128-sphere SoA (2 KiB) is read by scalar loads inside `scf.for` sweeps and
stays in L1. A sub-block whose primary rays all miss or hit lights skips
every bounce sweep (`skip_empty_tiles`: the block-level form of the
reference's SIMT `while` exit, glsl:280).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from l2n.camera.camera import ROW_PROJ
from l2n.ops.intersect import intersect_sphere_scene, sphere_scene_anyhit
from l2n.ops.pathtrace import Hit, generate_rays, shade
from l2n.render.state import FrameState
from l2n.render.step import global_sample_index
from l2n.render.tiles import advance_offset, scheduled_tiles
from l2n.rng.sampler import (
    TausLCGSampler,
    ThreefrySampler,
    TinyMTSampler,
    max_pairs_per_sample,
)
from l2n.scene.spheres import spheres_disjoint

# Pixels per program (rows, cols) and warps per program. Triton tensors
# are powers of two; the path state is ~40 live f32 values per pixel, and
# two pixels per thread (256 over 4 warps) measured fastest of the seven
# shapes tried on the H100 (PERF.md).
BLOCK_SHAPE = (16, 16)
NUM_WARPS = 4


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap that divides n."""
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def kernel_block(cfg) -> tuple[int, int]:
    """(rows, cols) of one program's pixel block: BLOCK_SHAPE, shrunk to
    powers of two that divide the tile (tiles are padded to whole tiles,
    so blocks never cross the framebuffer edge)."""
    return (_pow2_divisor(cfg.tile_height, BLOCK_SHAPE[0]),
            _pow2_divisor(cfg.tile_width, BLOCK_SHAPE[1]))


def _sampler(cfg, rng_words, pixel_index, sample_index):
    if cfg.rng == "threefry":
        return ThreefrySampler(cfg.seed, 0, pixel_index, sample_index,
                               max_pairs_per_sample(cfg.max_bounces, cfg.nee,
                                                    cfg.fog_density > 0))
    if cfg.rng == "tinymt":
        return TinyMTSampler(tuple(rng_words[:4]), tuple(rng_words[4:7]))
    if cfg.rng == "tauslcg":
        return TausLCGSampler(tuple(rng_words[:4]))
    raise ValueError(cfg.rng)  # pragma: no cover


def safe_gamma(x, gamma: float):
    """pow(x, gamma) for x >= 0 without NaN at 0 (exp/log form); the
    display transform pow(rgb/n, 0.45) (glsl:392)."""
    g = jnp.float32(gamma)
    safe = jnp.maximum(x, jnp.float32(1e-30))
    return jnp.where(x <= 0.0, jnp.float32(0.0), jnp.exp(g * jnp.log(safe)))


def _kernel(cfg, n_spheres, outside_ok, block, sample_stride, lights,
            sched_ref, cam_ref, cx_ref, cy_ref, cz_ref, r2_ref, accum_in,
            _out_in, *refs):
    stateful = cfg.rng_stateful
    if stateful:
        rng_in, accum_out, out_out, rng_out = refs
    else:
        accum_out, out_out = refs
    f32 = jnp.float32
    bh, bw = block
    per_row = cfg.tile_width // bw
    i = pl.program_id(0)
    j = pl.program_id(1)
    tile_x = sched_ref[i, 0]
    tile_y = sched_ref[i, 1]
    r0 = tile_y * cfg.tile_height + (j // per_row) * bh
    c0 = tile_x * cfg.tile_width + (j % per_row) * bw
    rows, cols = pl.ds(r0, bh), pl.ds(c0, bw)
    # Sharding extras (zero on a single device; see camera.py layout).
    row_offset = cam_ref[ROW_PROJ, 2].astype(jnp.int32)
    sample_rank = cam_ref[ROW_PROJ, 3].astype(jnp.int32)
    row = jax.lax.broadcasted_iota(jnp.int32, block, 0) + r0 + row_offset
    col = jax.lax.broadcasted_iota(jnp.int32, block, 1) + c0
    # pixelIndex = x + y * width (glsl:365) over the padded global grid.
    pixel_index = (col + row * cfg.padded_width).astype(jnp.uint32)
    # Whole tiles are scheduled and cleared, so the sample count is uniform
    # over the block: one scalar read.
    sample_index = accum_in[3, r0, c0].astype(jnp.int32).astype(jnp.uint32)
    rng_words = ([rng_in[k, rows, cols] for k in range(rng_in.shape[0])]
                 if stateful else None)

    def fetch(s):
        return cx_ref[s], cy_ref[s], cz_ref[s], r2_ref[s]

    def nearest(ox, oy, oz, dx, dy, dz, assume_outside) -> Hit:
        t, px, py, pz, nx, ny, nz, idx, br2 = intersect_sphere_scene(
            ox, oy, oz, dx, dy, dz, n_spheres, fetch,
            assume_outside=assume_outside, fast_math=cfg.fast_math)
        return Hit(t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
                   index=idx, emis_r2=br2)

    def intersect(ox, oy, oz, dx, dy, dz) -> Hit:
        # Bounce/shadow sweeps: origins sit on sphere surfaces, so in a
        # disjoint scene the t2 fallback is provably dead (spheres_disjoint).
        return nearest(ox, oy, oz, dx, dy, dz, outside_ok)

    def intersect_primary(ox, oy, oz, dx, dy, dz) -> Hit:
        # The camera may sit inside a sphere (the reference then returns
        # the t2 exit root), so the primary sweep keeps the full test.
        return nearest(ox, oy, oz, dx, dy, dz, False)

    def intersect_anyhit(ox, oy, oz, dx, dy, dz):
        return sphere_scene_anyhit(ox, oy, oz, dx, dy, dz, n_spheres, fetch,
                                   assume_outside=outside_ok)

    light_sampler = None
    if cfg.nee:
        from l2n.ops.nee import make_sphere_light_sampler
        light_sampler = make_sphere_light_sampler(
            n_spheres, cfg.emissive_every, fetch)

    sum_r = sum_g = sum_b = jnp.zeros(block, f32)
    for s in range(cfg.spp_per_step):
        sampler = _sampler(cfg, rng_words, pixel_index, global_sample_index(
            sample_index + jnp.uint32(s), sample_rank, sample_stride))
        u1, u2 = sampler.draw2()  # pixel jitter (glsl:371)
        rays = generate_rays(cfg, cam_ref, col.astype(f32), row.astype(f32),
                             u1, u2)
        r, g, b = shade(cfg, intersect, sampler, *rays,
                        skip_empty=cfg.skip_empty_tiles,
                        intersect_primary=intersect_primary,
                        intersect_anyhit=intersect_anyhit,
                        light_sampler=light_sampler, lights=lights)
        sum_r, sum_g, sum_b = sum_r + r, sum_g + g, sum_b + b
        if stateful:
            # Stateful modes chain their per-pixel streams sample to sample.
            rng_words = list(sampler.final_state()) + rng_words[4:]

    # newEstimate = current + (color_sum, spp); out = pow(rgb/n, gamma)
    # (glsl:391-395).
    n = accum_in[3, rows, cols] + f32(cfg.spp_per_step)
    inv = f32(1.0) / n
    for c, total in enumerate((sum_r, sum_g, sum_b)):
        acc = accum_in[c, rows, cols] + total
        accum_out[c, rows, cols] = acc
        out_out[c, rows, cols] = safe_gamma(acc * inv, cfg.gamma)
    accum_out[3, rows, cols] = n
    if stateful:
        for k, word in enumerate(rng_words):
            rng_out[k, rows, cols] = word


def build_sphere_call(cfg, scene, lights=None, interpret: bool = False,
                      sample_stride: int = 1):
    """The raw pallas_call over one framebuffer (or one shard's slab).

    Signature of the returned callable:
      call(sched (K,2) i32, camera (10,4) f32, cx, cy, cz, r2 (n,) f32,
           accum, output[, rng_state]) -> (accum, output[, rng_state])
    Used by the single-device step below and, per shard, inside the
    multi-device shard_map step (l2n.parallel.step), where the camera
    carries the slab's row offset and the sample replica's rank
    (`sample_stride` replicas; render.step.global_sample_index).
    `interpret=True` runs the kernel in the Pallas interpreter (CPU tests);
    otherwise it compiles through Triton for the GPU.
    """
    block = kernel_block(cfg)
    bh, bw = block
    hp, wp = cfg.padded_height, cfg.padded_width
    sub_blocks = (cfg.tile_height // bh) * (cfg.tile_width // bw)
    out_shape = [jax.ShapeDtypeStruct((4, hp, wp), jnp.float32),
                 jax.ShapeDtypeStruct((3, hp, wp), jnp.float32)]
    # Operands: sched, camera, cx, cy, cz, r2, accum, output[, rng].
    aliases = {6: 0, 7: 1}
    if cfg.rng_stateful:
        planes = 8 if cfg.rng == "tinymt" else 4
        out_shape.append(jax.ShapeDtypeStruct((planes, hp, wp), jnp.uint32))
        aliases[8] = 2
    # Exact t1-only bounce sweeps for provably disjoint scenes (the default
    # procedural scene does NOT qualify — see spheres_disjoint).
    outside_ok = spheres_disjoint(scene, margin=2.0 * cfg.ray_epsilon)
    return pl.pallas_call(
        partial(_kernel, cfg, scene.count, outside_ok, block, sample_stride,
                lights),
        grid=(cfg.effective_tiles_per_step, sub_blocks),
        out_shape=out_shape,
        input_output_aliases=aliases,
        interpret=interpret,
        backend=None if interpret else "triton",
        compiler_params=None if interpret else pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1),
        name="sphere_pt",
    )


def build_sphere_step(cfg, scene, tile_array, donate: bool = True,
                      steps_per_call: int = 1, lights=None,
                      interpret: bool = False):
    """Returns the jitted step(FrameState, packed_camera) -> FrameState."""
    call = build_sphere_call(cfg, scene, lights=lights, interpret=interpret)
    tile_array = jnp.asarray(tile_array)
    k = cfg.effective_tiles_per_step
    spheres = tuple(jnp.asarray(a) for a in (
        scene.center_x, scene.center_y, scene.center_z, scene.sqr_radius))

    def kernel_step(state: FrameState, camera) -> FrameState:
        sched = scheduled_tiles(tile_array, state.tile_offset, k)
        args = [sched, camera, *spheres, state.accum, state.output]
        if cfg.rng_stateful:
            args.append(state.rng_state)
        outs = call(*args)
        return FrameState(
            accum=outs[0],
            output=outs[1],
            tile_offset=advance_offset(cfg, state.tile_offset),
            iteration=state.iteration + 1,
            rng_state=outs[2] if cfg.rng_stateful else None,
        )

    step = kernel_step
    if steps_per_call > 1:
        step = lambda state, camera: jax.lax.fori_loop(
            0, steps_per_call, lambda _, st: kernel_step(st, camera), state)
    return jax.jit(step, donate_argnums=(0,) if donate else ())
