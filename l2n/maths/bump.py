"""Procedural normal mapping — the third item of the reference wishlist's
materials line (l2n-renderer/TODO.md:5 "Better materials (microfacet,
disney bsdf, normal mapping)").

The reference has no UV-mapped textures to source a normal map from, so —
exactly like its procedural hashed albedo (`getColor`,
sphere_pathtracing.cs.glsl:215-222) — the map is procedural: a smooth
world-space sine height field

    h(p) = (A / f) * (sin(f*px) + sin(f*py) + sin(f*pz))
    grad h = A * (cos(f*px), cos(f*py), cos(f*pz))

whose tangent-plane gradient perturbs the shading normal (Blinn bump
mapping, expressed in world space):

    g_t = g - (g . n) n
    n'  = normalize(n - g_t)

World-space means one formula covers analytic spheres AND arbitrary OBJ
triangle meshes with no UV parametrization, and it is trivially identical
across the three implementations (XLA oracle, Pallas kernels — both trace
this module — and the native C++ renderer's twin in l2n_native.cpp).

Per-object amplitude comes from the same fract(sin) hash family as the
albedo/roughness channels, so every object gets a different bumpiness.
Everything is lane-lockstep elementwise math: 3 cos + a dot + a rsqrt per vertex.
"""

from __future__ import annotations

import jax.numpy as jnp

from l2n.maths.sampling import dot3, normalize3


def procedural_bump_amplitude(index):
    """Per-object bump amplitude in [0.25, 1.0] from the reference's
    fract(sin) hash family (a further channel alongside albedo's three,
    roughness's fourth and the Disney channels)."""
    f = (index + 1).astype(jnp.float32)
    v = jnp.sin(f * jnp.float32(91.173)) * jnp.float32(43758.5453)
    h = v - jnp.floor(v)
    return jnp.float32(0.25) + jnp.float32(0.75) * h


def perturb_normal(cfg, index, px, py, pz, nx, ny, nz):
    """Unit shading normal perturbed by the procedural bump field.

    (nx, ny, nz) need not be unit (the reference's sphere path hands around
    unnormalized normals); the result is unit. Gated by the caller on
    cfg.normal_map > 0 so the unmapped tracer stays bit-identical.
    """
    f32 = jnp.float32
    nx, ny, nz = normalize3(nx, ny, nz)
    amp = f32(cfg.normal_map) * procedural_bump_amplitude(index)
    freq = f32(cfg.normal_map_freq)
    gx = amp * jnp.cos(freq * px)
    gy = amp * jnp.cos(freq * py)
    gz = amp * jnp.cos(freq * pz)
    g_n = dot3(gx, gy, gz, nx, ny, nz)
    return normalize3(nx - (gx - g_n * nx),
                      ny - (gy - g_n * ny),
                      nz - (gz - g_n * nz))
