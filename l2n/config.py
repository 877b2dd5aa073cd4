"""Render configuration.

The reference hard-codes every knob (window 1280x720 `src/main.cpp:120-121`,
fovy 45deg `src/main.cpp:827-828`, tile size 32 `src/main.cpp:830`, sphere
count 128 / world size 1024 `src/main.cpp:656-657`, path-length cap
`sphere_pathtracing.cs.glsl:280`, Russian-roulette ceiling `:303`) and exposes
only `tileCountPerIteration` + renderer choice in the GUI (`src/main.cpp:974-980`).
Here every one of those is a field of a JSON-serializable dataclass.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


# Reference defaults (src/main.cpp + kernels).
DEFAULT_WIDTH = 1280   # src/main.cpp:120
DEFAULT_HEIGHT = 720   # src/main.cpp:121
DEFAULT_FOVY_DEG = 45.0  # src/main.cpp:827
DEFAULT_SPHERE_COUNT = 128  # src/main.cpp:656
DEFAULT_WORLD_SIZE = 1024.0  # src/main.cpp:657


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) configuration of a render.

    All fields are Python scalars so a config uniquely keys a compiled
    render step; changing any field recompiles.
    """

    # Image / projection -----------------------------------------------------
    width: int = DEFAULT_WIDTH
    height: int = DEFAULT_HEIGHT
    # NDC denominators when this config describes a SLAB of a larger sharded
    # framebuffer (0 = use width/height). Ray generation must map pixel
    # coords against the full image even when buffers are slab-local.
    ndc_width: int = 0
    ndc_height: int = 0
    fovy_deg: float = DEFAULT_FOVY_DEG
    near: float = 0.01   # src/main.cpp:828
    far: float = 100.0   # src/main.cpp:828

    # Tile scheduler ---------------------------------------------------------
    # The reference uses 32x32 GL workgroups (sphere_pathtracing.cs.glsl:5).
    # The default is a (32, 128) scheduling tile; the GPU kernel splits each
    # tile into smaller pixel blocks (ops/kernels/sphere_pt.BLOCK_SHAPE).
    tile_height: int = 32
    tile_width: int = 128
    # Tiles dispatched per step; the reference defaults to one row of tiles
    # (tileCountPerIteration = tileCountX, src/main.cpp:834).
    tiles_per_step: int = 0  # 0 => one row (tile_count_x), like the reference
    tile_shuffle_seed: int = 0  # fixed-seed shuffle (std::mt19937, main.cpp:844)
    # Samples per pixel per scheduled tile per step. The reference always
    # takes 1 (one dispatch = one sample, glsl:391); >1 amortizes per-tile
    # fixed costs (loads, tonemap, scheduling) across samples.
    spp_per_step: int = 1

    # Path tracing -----------------------------------------------------------
    # Reference caps at pathLength <= 1, i.e. at most 2 path segments
    # (sphere_pathtracing.cs.glsl:280).
    max_bounces: int = 2
    rr_ceiling: float = 0.9       # min(0.9, luminance) sphere_pathtracing.cs.glsl:303
    emissive_every: int = 16      # sphereIndex % 16 == 0 => emissive (glsl:285)
    emission_scale: float = 8192.0  # glsl:288
    ray_epsilon: float = 0.01     # bounce-origin offset (glsl:305)
    env_mode: str = "mandelbrot"  # "mandelbrot" (GPU, glsl:313) | "sun" (CPU, main.cpp:445) | "none"
    env_scale: float = 3.0        # glsl:314
    # Next event estimation (reference TODO.md wishlist): sample the
    # emissive objects explicitly at every diffuse vertex and cast a shadow
    # ray. Sphere scenes sample light AREA; triangle scenes sample the SOLID
    # ANGLE of each emissive mesh's bounding sphere (no per-lane geometry
    # gathers — lane-lockstep and unbiased for arbitrary meshes). Without
    # `mis`, indirect BSDF emission hits are suppressed (still unbiased).
    nee: bool = False
    # Multiple importance sampling (balance heuristic) between the NEE and
    # BSDF strategies: emission found by BSDF rays and NEE contributions are
    # both kept, weighted by their pdfs — robust when lights get large.
    mis: bool = False

    # Scene ------------------------------------------------------------------
    scene_kind: str = "sphere"    # "sphere" | "triangle" (renderer combo, main.cpp:976)
    sphere_count: int = DEFAULT_SPHERE_COUNT
    world_size: float = DEFAULT_WORLD_SIZE
    scene_seed: int = 0
    disc_lat: int = 16            # tessellation, src/main.cpp:733
    disc_long: int = 8            # src/main.cpp:734
    # OBJ scene source for the triangle renderer ("" = the procedural
    # tessellation above). Carried in the config so session checkpoints
    # (utils/checkpoint.py) record WHICH scene the accumulation belongs
    # to — a resumed OBJ render rebuilds the same geometry, and resuming
    # into a different scene fails the config-match check instead of
    # silently accumulating mismatched radiance.
    obj_path: str = ""

    # Shading model. "procedural" = the reference's hashed-albedo Lambert
    # (glsl:215-222,292-300); "microfacet" = GGX/Smith specular over a
    # Lambert base with per-object procedural roughness (the reference's
    # TODO.md:5 wishlist item), importance-sampled as a two-lobe mixture;
    # "disney" = the wishlist's named principled model (lite: Burley
    # diffuse + sheen + colored-Fresnel GGX with per-object procedural
    # metallic/specular/sheen channels; maths/brdf.py).
    material_mode: str = "procedural"

    # Normal mapping (the third item of the reference's wishlist materials
    # line, TODO.md:5 "Better materials (microfacet, disney bsdf, normal
    # mapping)"). A world-space procedural bump field perturbs the SHADING
    # normal before any BSDF/NEE evaluation:
    #   g  = A * (cos(f*px), cos(f*py), cos(f*pz))   (grad of a sine height field)
    #   n' = normalize(n - (g - (g.n) n))            (Blinn bump, world-space)
    # A = normal_map * per-object hash amplitude (the same fract(sin) family
    # as the reference's albedo, glsl:215-222); f = normal_map_freq. Being
    # world-space it covers spheres and arbitrary OBJ meshes with one
    # formula (no UV parametrization), and composes with every
    # material_mode. 0 = off, bit-identical to the unmapped tracer.
    normal_map: float = 0.0        # global bump strength (0 disables)
    normal_map_freq: float = 0.35  # bump field wavenumber (world units^-1)

    # Homogeneous participating medium (reference wishlist TODO.md:16
    # "volumetrics"), rendered by unbiased collision (distance) sampling:
    # each path segment draws t_fog ~ Exp(fog_density); a collision before
    # the surface scatters isotropically with throughput *= fog_albedo.
    # The environment sits at a finite fog_sky_distance (0 = auto,
    # 4 * world_size) — with an infinite homogeneous medium the sky would
    # be unreachable. 0 density = off, bit-identical to no-fog tracing
    # (the fog draws are gated at trace time). Requires a stateless
    # sampler. Composes with NEE (analytic exp(-sigma*d) shadow
    # transmittance, ops/nee.py) and with NEE+MIS: the balance weights
    # stay the angular pdfs (transmittance is a deterministic factor on
    # each strategy's contribution, not a pdf — NEE folds exp(-sigma*d)
    # analytically, the BSDF side carries it implicitly as collision-
    # sampling survival), except that rays scattered at a fog vertex keep
    # FULL emission weight because fog vertices take no NEE
    # (ops/pathtrace.py::_resolve_vertex).
    fog_density: float = 0.0      # sigma_t per world unit
    fog_albedo: float = 0.9       # sigma_s / sigma_t (scatter fraction)
    fog_sky_distance: float = 0.0  # 0 = auto (4 * world_size)

    # Ray generation: "fovy" = the GPU kernel's inverse-view + tan(fovy/2)
    # trick (sphere_pathtracing.cs.glsl:378-384); "viewproj" = the CPU
    # renderer's full inverse view-projection (src/main.cpp:562-567).
    ray_gen: str = "fovy"

    # RNG --------------------------------------------------------------------
    # "threefry": counter-based, keyed on (pixel, sample, draw) — default.
    # "tinymt":   bit-exact TinyMT32 port carrying per-pixel 32B state
    #             (reference semantics, src/main.cpp:859-878).
    # "tauslcg":  combined Tausworthe/LCG (reference alt module,
    #             src/shaders/rand_TausLCG.cs.glsl — present but unused there too).
    rng: str = "threefry"
    seed: int = 0

    # Kernel tuning ------------------------------------------------------------
    # Skip whole bounce sweeps in a kernel block when no lane is alive (the
    # analog of the reference's SIMT while-exit, glsl:280). Automatically
    # disabled for stateful RNG parity modes (stream sync).
    skip_empty_tiles: bool = True
    # Fast-math roots: compute the per-candidate sphere sweeps' sqrt(disc)
    # as disc * rsqrt(disc) (ops/intersect.py, the reference's
    # intersectSphere root math, sphere_pathtracing.cs.glsl:145-163).
    # Lengths are always inverted through rsqrt (maths/sampling.normalize3),
    # so this is the one switch. Values differ from the exact form only in
    # final-ulp rounding, which can flip measure-zero discrete events (which
    # sphere wins a near-tie, RR survival at a threshold, an exact-tangent
    # disc == 0 hit becomes a miss); the estimator stays unbiased and is held
    # to the 1024x1024 per-sample RMSE < 1e-3 gate against the oracle
    # (chip_smoke.py). Threaded identically through the oracle AND the
    # kernel, so oracle/kernel parity holds with the flag either way. Off
    # by default: the exact form is the class used by all golden tests.
    fast_math: bool = False

    # Debug / AOV ------------------------------------------------------------
    # "pathtracing" | "normal" | "ambient_occlusion" | "hit" | "tex_coords"
    # | "param_uv" — the reference's comment-toggled debug channels
    # (sphere_pathtracing.cs.glsl:386-389, triangle_pathtracing.cs.glsl:406-409).
    aov: str = "pathtracing"

    # Display ----------------------------------------------------------------
    gamma: float = 0.45           # pow(rgb/n, 0.45), glsl:392

    # ------------------------------------------------------------------------
    @property
    def rng_stateful(self) -> bool:
        """True when the sampler carries per-pixel state planes (the
        reference-parity modes); threefry is stateless."""
        return self.rng in ("tinymt", "tauslcg")

    @property
    def tan_half_fovy(self) -> float:
        return math.tan(0.5 * math.radians(self.fovy_deg))

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def padded_width(self) -> int:
        """Framebuffer width rounded up to the tile grid. The reference
        bounds-guards partial tiles in-kernel (glsl:361-363); here the
        framebuffer is instead padded so every tile is full (the pad pixels
        render but are cropped at display)."""
        return self.tile_count_x * self.tile_width

    @property
    def padded_height(self) -> int:
        return self.tile_count_y * self.tile_height

    @property
    def tile_count_x(self) -> int:
        return -(-self.width // self.tile_width)

    @property
    def tile_count_y(self) -> int:
        return -(-self.height // self.tile_height)

    @property
    def tile_count(self) -> int:
        return self.tile_count_x * self.tile_count_y

    @property
    def effective_tiles_per_step(self) -> int:
        n = self.tiles_per_step if self.tiles_per_step > 0 else self.tile_count_x
        return min(n, self.tile_count)

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")
        if self.scene_kind not in ("sphere", "triangle"):
            raise ValueError(f"unknown scene_kind {self.scene_kind!r}")
        if self.obj_path and self.scene_kind != "triangle":
            raise ValueError("obj_path requires scene_kind='triangle'")
        if self.rng not in ("threefry", "tinymt", "tauslcg"):
            raise ValueError(f"unknown rng {self.rng!r}")
        if self.env_mode not in ("mandelbrot", "sun", "none"):
            raise ValueError(f"unknown env_mode {self.env_mode!r}")
        if self.ray_gen not in ("fovy", "viewproj"):
            raise ValueError(f"unknown ray_gen {self.ray_gen!r}")
        if self.nee and self.rng != "threefry":
            raise ValueError("nee requires a stateless sampler (threefry)")
        if self.mis and not self.nee:
            raise ValueError("mis requires nee")
        if self.material_mode not in ("procedural", "microfacet", "disney"):
            raise ValueError(f"unknown material_mode {self.material_mode!r}")
        if self.aov not in ("pathtracing", "normal", "ambient_occlusion",
                            "hit", "tex_coords", "param_uv"):
            raise ValueError(f"unknown aov {self.aov!r}")
        if self.normal_map < 0.0 or self.normal_map_freq <= 0.0:
            raise ValueError("normal_map must be >= 0 and normal_map_freq "
                             "> 0")
        if self.fog_density < 0.0 or not (0.0 <= self.fog_albedo <= 1.0):
            raise ValueError("fog_density must be >= 0 and fog_albedo in "
                             "[0, 1]")
        if self.fog_density > 0.0:
            if self.rng != "threefry":
                raise ValueError("fog requires a stateless sampler "
                                 "(threefry)")
            if self.emissive_every <= 1:
                raise ValueError(
                    "fog requires emissive_every > 1: fog collisions mark "
                    "their vertex non-emissive via the index sentinel 1, "
                    "which must not be an emissive index")
        return self

    # JSON round-trip ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        data: dict[str, Any] = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known}).validate()

    def replace(self, **kw: Any) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
