"""Materials and explicit lights (SoA containers).

The reference declares Phong materials, point lights and directional lights
and binds std430 buffers for them (`PhongMaterial`/`PointLight`/
`DirectionalLight`, l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:
9-38, buffers :52-69, counts :50-65) — but its shading never reads them:
albedo is the procedural hash (glsl:282) and emission the every-16th-sphere
rule (glsl:285-290), and its counts stay zero (main.cpp:675-693).

These SoA containers carry that declared surface — and since round 4 they
are LIVE (ops/lights.py): pass them to a program and point/directional
lights contribute deterministic direct lighting at every diffuse vertex
while `PhongMaterials.diffuse.rgb` overrides the per-object procedural
albedo (index-keyed; the remaining Phong channels are carried-but-unread,
exactly as declared). Empty buffers — the reference's own state — remain
the default and compile the identical program.

The procedural material system is `RenderConfig.material_mode`:
"procedural" keeps reference parity, "microfacet"/"disney" enable the
wishlist BSDFs (l2n.maths.brdf) with per-object procedural parameters;
explicit lights evaluate whichever BSDF is active.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp


def _soa(arr, n_components):
    a = np.asarray(arr, np.float32).reshape(-1, n_components)
    return tuple(jnp.asarray(a[:, i]) for i in range(n_components))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhongMaterials:
    """PhongMaterial { vec4 diffuse; vec3 glossy; float shininess; }
    (glsl:9-14), SoA."""

    diffuse_r: jnp.ndarray
    diffuse_g: jnp.ndarray
    diffuse_b: jnp.ndarray
    diffuse_a: jnp.ndarray
    glossy_r: jnp.ndarray
    glossy_g: jnp.ndarray
    glossy_b: jnp.ndarray
    shininess: jnp.ndarray

    @classmethod
    def from_arrays(cls, diffuse, glossy, shininess) -> "PhongMaterials":
        d = _soa(diffuse, 4)
        g = _soa(glossy, 3)
        s = jnp.asarray(np.asarray(shininess, np.float32).reshape(-1))
        return cls(*d, *g, s)

    @property
    def count(self) -> int:
        return self.shininess.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointLights:
    """PointLight { vec3 position; vec3 radiantIntensity; } (glsl:24-30)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    intensity_r: jnp.ndarray
    intensity_g: jnp.ndarray
    intensity_b: jnp.ndarray

    @classmethod
    def from_arrays(cls, positions, intensities) -> "PointLights":
        return cls(*_soa(positions, 3), *_soa(intensities, 3))

    @property
    def count(self) -> int:
        return self.x.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DirectionalLights:
    """DirectionalLight { vec3 incidentDirection; vec3 emittedRadiance; }
    (glsl:32-38)."""

    dir_x: jnp.ndarray
    dir_y: jnp.ndarray
    dir_z: jnp.ndarray
    radiance_r: jnp.ndarray
    radiance_g: jnp.ndarray
    radiance_b: jnp.ndarray

    @classmethod
    def from_arrays(cls, directions, radiances) -> "DirectionalLights":
        return cls(*_soa(directions, 3), *_soa(radiances, 3))

    @property
    def count(self) -> int:
        return self.dir_x.shape[0]


def empty_lights() -> tuple[PhongMaterials, PointLights, DirectionalLights]:
    """Zero-count buffers — the reference's default state (counts of 0)."""
    z3 = np.zeros((0, 3), np.float32)
    return (PhongMaterials.from_arrays(np.zeros((0, 4), np.float32), z3,
                                       np.zeros(0, np.float32)),
            PointLights.from_arrays(z3, z3),
            DirectionalLights.from_arrays(z3, z3))
