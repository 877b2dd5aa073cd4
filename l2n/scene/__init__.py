"""Scene layer: procedural sphere scene and tessellated triangle scene.

Scenes are immutable structure-of-arrays pytrees (jnp arrays), the analog
of the reference's std430 GL buffer uploads (`SphereProgram`
l2n-renderer/src/main.cpp:695-712, `TriangleProgram` :714-788).
"""

from l2n.scene.spheres import SphereScene, compute_spheres  # noqa: F401
from l2n.scene.tessellate import (  # noqa: F401
    TriangleScene,
    tessellate_sphere,
    tessellate_sphere_info,
    build_triangle_scene,
)
from l2n.scene.materials import (  # noqa: F401
    DirectionalLights,
    PhongMaterials,
    PointLights,
    empty_lights,
)
