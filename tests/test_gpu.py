"""Physics gates for the compiled kernel on the GPU.

Marked `gpu`: the `gpu` fixture skips them where JAX has no GPU. Run on a
GPU machine (from the repository root) with

    python -m pytest tests -m gpu

Compiled code genuinely differs from the oracle in fma contraction and in
the rounding of sqrt/rsqrt/exp/log, so draw-heavy compositions flip more
floating-point ties (near-tie hit winners, Russian-roulette thresholds)
than the CPU interpreter's 1e-3 budget: each flip changes that sample
wholesale. The gates are therefore exact sample counts, a flip-fraction
bound, and agreement of the estimator means.
"""

import numpy as np
import jax
import pytest

from l2n.config import RenderConfig
from l2n.render.state import init_frame_state
from l2n.render.step import build_render_step

pytestmark = pytest.mark.gpu

BASE = RenderConfig(width=256, height=128, tile_height=32, tile_width=128,
                    tiles_per_step=8, spp_per_step=4).validate()


def _accums(steps_by_name, cfg, cam, steps=2):
    out = {}
    for name, step in steps_by_name.items():
        st = init_frame_state(cfg)
        for _ in range(steps):
            st = step(st, cam)
        out[name] = np.asarray(st.accum)
    return out


def _gate(a, b, flip_budget, mean_tol):
    assert (a[:3].max(0) > 0).mean() > 0.1, "near-black comparison"
    np.testing.assert_array_equal(a[3], b[3])
    flipped = (np.abs(a - b) > 1e-3).mean()
    assert flipped < flip_budget, float(flipped)
    for c in range(3):
        ma, mb = float(a[c].mean()), float(b[c].mean())
        assert abs(ma - mb) < mean_tol * max(ma, 1e-6), (c, ma, mb)


def _program_steps(cfg, **kw):
    from l2n.render.program import SphereProgram
    steps = {}
    for backend in ("xla", "pallas"):
        steps[backend] = SphereProgram(cfg, backend=backend, **kw).step
    return steps


def test_fog_nee_mis_kernel(gpu):
    """Homogeneous fog + NEE + MIS through the compiled kernel."""
    from test_brdf import TestRenderIntegration
    cfg = BASE.replace(emissive_every=2, nee=True, mis=True,
                       fog_density=0.0008, fog_albedo=0.8)
    cam = TestRenderIntegration._aimed_camera(cfg).packed()
    acc = _accums(_program_steps(cfg), cfg, cam)
    _gate(acc["xla"], acc["pallas"], flip_budget=1e-2, mean_tol=0.01)


def test_explicit_lights_kernel(gpu):
    """Live light/material buffers through the compiled kernel. Dirac
    lights make hard shadow edges, where every silhouette pixel is a
    floating-point knife edge, so the flip bound is looser and the gate is
    channel-wise estimator agreement."""
    from l2n.scene.materials import (
        DirectionalLights,
        PhongMaterials,
        PointLights,
    )
    from test_brdf import TestRenderIntegration
    mats = PhongMaterials.from_arrays(
        np.array([[0.9, 0.2, 0.1, 1.0], [0.1, 0.8, 0.3, 1.0]], np.float32),
        np.zeros((2, 3), np.float32), np.zeros(2, np.float32))
    pls = PointLights.from_arrays(np.array([[0.0, 0.0, 0.0]], np.float32),
                                  np.array([[5e7, 4e7, 3e7]], np.float32))
    dls = DirectionalLights.from_arrays(
        np.array([[0.3, -1.0, 0.2]], np.float32),
        np.array([[0.5, 0.5, 0.6]], np.float32))
    cam = TestRenderIntegration._aimed_camera(BASE).packed()
    acc = _accums(_program_steps(BASE, materials=mats, point_lights=pls,
                                 directional_lights=dls), BASE, cam)
    _gate(acc["xla"], acc["pallas"], flip_budget=0.10, mean_tol=0.02)


def test_trefoil_oracle_gpu_vs_cpu(gpu):
    """A 7,680-triangle trefoil mesh through the oracle compiled for the GPU
    against the same oracle compiled for the host CPU (the full 70k mesh
    takes minutes on the host)."""
    from l2n.scene.obj import load_obj
    from l2n.scene.procgen import trefoil_obj
    from test_bigmesh import aimed_camera
    cfg = RenderConfig(width=128, height=64, tile_height=32, tile_width=128,
                       tiles_per_step=2, spp_per_step=2,
                       scene_kind="triangle").validate()
    scene = load_obj(trefoil_obj(seg_u=96, seg_v=40))
    assert scene.total_triangles == 7680
    cam = aimed_camera(cfg, scene).packed()
    step = build_render_step(cfg, scene, backend="xla")
    with jax.default_device(jax.devices("cpu")[0]):
        acc_cpu = _accums({"cpu": step}, cfg, cam)["cpu"]
    acc_gpu = _accums({"gpu": step}, cfg, cam)["gpu"]
    _gate(acc_cpu, acc_gpu, flip_budget=1e-2, mean_tol=0.01)
