#!/usr/bin/env python
"""Benchmark of the path tracer on one NVIDIA GPU; prints one JSON line.

Stages, all at 1024x1024 in one process:
  headline  the 128-sphere procedural scene, max_bounces=2 with Russian
            roulette, Mandelbrot environment, whole-frame steps of 4 spp,
            threefry — the compiled kernel with fast_math on and off;
  triangle  the tessellated scene (128 meshes x 256 triangles), oracle;
  obj       the 18k-triangle torus-field OBJ scene, oracle;
  bigobj    the 70k-triangle trefoil knot, oracle.

Timing: warm-up calls (compilation is reported separately), then a window
of steps ended by block_until_ready. A "ray" is a path segment actually
cast — 1 primary per sample plus one per Russian-roulette survivor,
measured on this scene and camera by an instrumented oracle pass.

Usage: python bench.py [--stage headline|triangle|obj|bigobj|all]
Fails (non-zero exit, no JSON) when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def device_record() -> dict:
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench: JAX's first device is "
                         f"{devices[0].platform!r}, not a GPU")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"not reported ({type(e).__name__})"
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "nvidia_smi": smi,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def headline_cfg():
    from l2n.config import RenderConfig
    return RenderConfig(width=1024, height=1024, tile_height=32,
                        tile_width=128, tiles_per_step=1024, spp_per_step=4,
                        rng="threefry").validate()


def time_steps(step, state, camera, warmup: int = 2, steps: int = 10,
               reps: int = 3) -> tuple[float, float]:
    """(seconds of the first call, best seconds per step over `reps`
    windows of `steps`), each window ended by block_until_ready."""
    import jax
    packed = camera.packed()
    t0 = time.perf_counter()
    state = jax.block_until_ready(step(state, packed))
    first = time.perf_counter() - t0
    for _ in range(warmup - 1):
        state = step(state, packed)
    jax.block_until_ready(state)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state, packed)
        jax.block_until_ready(state)
        best = min(best, (time.perf_counter() - t0) / steps)
    return first, best


def measure_mean_segments(cfg, scene, camera) -> float:
    """Instrumented oracle pass at 256x256 samples of the frame: 1 + the
    sum of the Russian-roulette survivor fractions."""
    import jax
    import jax.numpy as jnp
    from l2n.ops.pathtrace import generate_rays, trace_path
    from l2n.render.step import make_intersector
    from l2n.rng.sampler import ThreefrySampler, max_pairs_per_sample

    intersect, _, _, _ = make_intersector(cfg, scene)
    h, w = 256, 256

    def survive_fractions(packed):
        py, px = jnp.meshgrid(
            jnp.arange(h, dtype=jnp.int32) * (cfg.height // h),
            jnp.arange(w, dtype=jnp.int32) * (cfg.width // w), indexing="ij")
        pixel_index = (px + py * jnp.int32(cfg.padded_width)).astype(
            jnp.uint32)
        sampler = ThreefrySampler(cfg.seed, 0, pixel_index,
                                  jnp.zeros((h, w), jnp.uint32),
                                  max_pairs_per_sample(cfg.max_bounces))
        u1, u2 = sampler.draw2()
        rays = generate_rays(cfg, packed, px.astype(jnp.float32),
                             py.astype(jnp.float32), u1, u2)
        stats: dict = {}
        trace_path(cfg, intersect, sampler, *rays, stats=stats)
        return jnp.stack(stats["survive_fraction"])

    fractions = jax.jit(survive_fractions)(jnp.asarray(camera.packed()))
    return 1.0 + float(jax.device_get(fractions).sum())


def stage_headline() -> dict:
    from l2n.camera import Camera
    from l2n.render.program import SphereProgram
    from l2n.render.state import init_frame_state
    from l2n.scene import compute_spheres

    cfg = headline_cfg()
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    camera = Camera.from_config(cfg)
    samples_per_step = (cfg.effective_tiles_per_step * cfg.tile_height
                        * cfg.tile_width * cfg.spp_per_step)
    mean_segments = measure_mean_segments(cfg, scene, camera)
    out = {"mean_segments_per_sample": mean_segments}
    for label, fast in (("fast", True), ("exact", False)):
        c = cfg.replace(fast_math=fast)
        prog = SphereProgram(c, scene=scene, backend="auto")
        first, dt = time_steps(prog.step, init_frame_state(c), camera)
        log(f"headline {label}: backend={prog.backend} first call "
            f"{first:.2f} s, {dt * 1e3:.4f} ms/step")
        out[label] = {
            "backend": prog.backend,
            "first_call_s": first,
            "ms_per_step": dt * 1e3,
            "mrays_per_sec": samples_per_step / dt * mean_segments / 1e6,
            "ms_per_full_frame_spp": dt * 1e3 * cfg.width * cfg.height
            / samples_per_step,
        }
    return {"headline": out}


def _triangle_stage(name, scene=None, camera=None) -> dict:
    from l2n.camera import Camera
    from l2n.render.program import TriangleProgram
    from l2n.render.state import init_frame_state

    cfg = headline_cfg().replace(scene_kind="triangle", spp_per_step=1)
    prog = TriangleProgram(cfg, scene=scene, backend="auto")
    camera = camera or Camera.from_config(cfg)
    first, dt = time_steps(prog.step, init_frame_state(cfg), camera,
                           warmup=1, steps=2, reps=2)
    ms = dt * 1e3 * cfg.width * cfg.height / (
        cfg.effective_tiles_per_step * cfg.tile_height * cfg.tile_width
        * cfg.spp_per_step)
    log(f"{name}: backend={prog.backend} "
        f"{prog.scene.total_triangles} triangles, first call {first:.2f} s, "
        f"{ms:.3f} ms per full-frame sample")
    return {name: {"backend": prog.backend, "first_call_s": first,
                   "triangles": int(prog.scene.total_triangles),
                   "ms_per_full_frame_spp": ms}}


def stage_triangle() -> dict:
    return _triangle_stage("triangle")


def stage_obj() -> dict:
    from l2n.scene.obj import load_obj
    from l2n.scene.procgen import torus_field_obj
    return _triangle_stage("obj", scene=load_obj(torus_field_obj()))


def stage_bigobj() -> dict:
    import numpy as np
    from l2n.camera import Camera
    from l2n.maths.linalg import look_at
    from l2n.scene.obj import load_obj
    from l2n.scene.procgen import trefoil_obj

    scene = load_obj(trefoil_obj())
    # The knot fills the view: a benchmark of sky pixels flatters nothing.
    verts = np.asarray(scene.vertices).reshape(-1, 3)
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    vm = look_at(target + np.array([0.35, 0.25, 1.0], np.float32)
                 * 1.45 * radius, target,
                 np.array([0.0, 1.0, 0.0], np.float32))
    camera = Camera.from_config(headline_cfg(), view_matrix=vm)
    return _triangle_stage("bigobj", scene=scene, camera=camera)


STAGES = {"headline": stage_headline, "triangle": stage_triangle,
          "obj": stage_obj, "bigobj": stage_bigobj}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stage", default="all",
                        choices=[*STAGES, "all"])
    args = parser.parse_args(argv)
    record = {"device": device_record()}
    from l2n.utils.compile_cache import enable
    enable()
    names = list(STAGES) if args.stage == "all" else [args.stage]
    for name in names:
        record.update(STAGES[name]())
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
