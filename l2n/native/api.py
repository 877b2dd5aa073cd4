"""ctypes bindings for the native tier (see src/l2n_native.cpp)."""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

import l2n.native as native_mod

_ENV_MODES = {"none": 0, "mandelbrot": 1, "sun": 2}
_RNG_MODES = {"threefry": 0, "tinymt": 1}
_RAY_GEN = {"fovy": 0, "viewproj": 1}
_AOVS = {"pathtracing": 0, "normal": 1, "hit": 2}


def _material_mode(cfg, sphere: bool) -> int:
    """Every material mode has a native C++ twin (brdf.py formulas, same
    draw order), so all three implementations cross-check all materials
    on both scene families."""
    del sphere
    mode = getattr(cfg, "material_mode", "procedural")
    try:
        return {"procedural": 0, "microfacet": 1, "disney": 2}[mode]
    except KeyError:
        raise NotImplementedError(
            f"native renderer does not implement material_mode={mode!r}"
        ) from None


class _CConfig(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("buf_width", ctypes.c_int32), ("buf_height", ctypes.c_int32),
        ("tile_width", ctypes.c_int32), ("tile_height", ctypes.c_int32),
        ("max_bounces", ctypes.c_int32),
        ("emissive_every", ctypes.c_int32),
        ("emission_scale", ctypes.c_float),
        ("rr_ceiling", ctypes.c_float),
        ("ray_epsilon", ctypes.c_float),
        ("env_mode", ctypes.c_int32),
        ("env_scale", ctypes.c_float),
        ("gamma", ctypes.c_float),
        ("rng_mode", ctypes.c_int32),
        ("seed", ctypes.c_uint32),
        ("stream", ctypes.c_uint32),
        ("max_pairs", ctypes.c_int32),
        ("ray_gen", ctypes.c_int32),
        ("aov", ctypes.c_int32),
        ("nee", ctypes.c_int32),
        ("normal_map", ctypes.c_float),
        ("normal_map_freq", ctypes.c_float),
        ("material_mode", ctypes.c_int32),
    ]


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def threefry2x32_native(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    lib = native_mod.load()
    x0 = np.ascontiguousarray(x0, np.uint32)
    x1 = np.ascontiguousarray(x1, np.uint32)
    o0 = np.empty_like(x0)
    o1 = np.empty_like(x1)
    lib.l2n_threefry2x32(
        ctypes.c_uint32(k0), ctypes.c_uint32(k1),
        x0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        x1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        o0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        o1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(x0.size))
    return o0, o1


def tinymt_uint32_native(mat1: int, mat2: int, tmat: int, seed: int, n: int):
    lib = native_mod.load()
    out = np.empty(n, np.uint32)
    lib.l2n_tinymt_uint32(
        ctypes.c_uint32(mat1), ctypes.c_uint32(mat2), ctypes.c_uint32(tmat),
        ctypes.c_uint32(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n))
    return out


@dataclasses.dataclass
class NativeRenderer:
    """Multithreaded CPU reference renderer over the same FrameState planes.

    The independent third implementation (after the Pallas kernels and the
    XLA oracle) — the role the reference's `CPUSpherePathtracing` plays
    (src/main.cpp:206-599), including its thread-pool tile queue.
    """

    cfg: object            # RenderConfig
    spheres: np.ndarray    # (N, 4) float32 [cx, cy, cz, sqrRadius]
    tiles: np.ndarray      # (T, 2) int32
    num_threads: int = 0   # 0 => hardware_concurrency

    def __post_init__(self):
        self.lib = native_mod.load()
        self.spheres = _f32(self.spheres).reshape(-1, 4)
        self.tiles = np.ascontiguousarray(self.tiles, np.int32)
        cfg = self.cfg
        if getattr(cfg, "fog_density", 0.0) > 0.0:
            raise ValueError("the native renderer does not implement fog "
                             "(its threefry stream layout has no "
                             "collision-distance draws)")
        from l2n.rng.sampler import max_pairs_per_sample
        self._c = _CConfig(
            width=cfg.width, height=cfg.height,
            buf_width=cfg.padded_width, buf_height=cfg.padded_height,
            tile_width=cfg.tile_width, tile_height=cfg.tile_height,
            max_bounces=cfg.max_bounces,
            emissive_every=cfg.emissive_every,
            emission_scale=cfg.emission_scale,
            rr_ceiling=cfg.rr_ceiling,
            ray_epsilon=cfg.ray_epsilon,
            env_mode=_ENV_MODES[cfg.env_mode],
            env_scale=cfg.env_scale,
            gamma=cfg.gamma,
            rng_mode=_RNG_MODES[cfg.rng],
            seed=cfg.seed, stream=0,
            max_pairs=max_pairs_per_sample(cfg.max_bounces, cfg.nee),
            ray_gen=_RAY_GEN[cfg.ray_gen],
            aov=_AOVS.get(cfg.aov, 0),
            nee=int(cfg.nee),
            normal_map=getattr(cfg, "normal_map", 0.0),
            normal_map_freq=getattr(cfg, "normal_map_freq", 0.35),
            material_mode=_material_mode(cfg, sphere=True),
        )

    def render_tiles(self, accum: np.ndarray, output: np.ndarray,
                     camera_packed: np.ndarray, offset: int, count: int,
                     rng_state: np.ndarray | None = None) -> None:
        """In-place render of `count` scheduled tiles (renderTiles,
        main.cpp:516-592). accum (4, Hp, Wp) and output (3, Hp, Wp) are
        updated; rng_state (8, Hp, Wp) uint32 is stepped for tinymt mode."""
        accum_c = np.ascontiguousarray(accum, np.float32)
        out_c = np.ascontiguousarray(output, np.float32)
        cam = _f32(camera_packed)
        if self._c.rng_mode == 1:
            if rng_state is None:
                raise ValueError("tinymt mode needs rng_state planes")
            rng_c = np.ascontiguousarray(rng_state, np.uint32)
            rng_ptr = rng_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        else:
            rng_c = None
            rng_ptr = None
        rc = self.lib.l2n_render_tiles(
            ctypes.byref(self._c),
            self.spheres.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int32(self.spheres.shape[0]),
            cam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(self.tiles.shape[0]),
            ctypes.c_int32(offset), ctypes.c_int32(count),
            accum_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rng_ptr, ctypes.c_int32(self.num_threads))
        if rc != 0:
            raise RuntimeError(f"native render failed: {rc}")
        accum[...] = accum_c
        output[...] = out_c
        if rng_c is not None:
            rng_state[...] = rng_c


@dataclasses.dataclass
class NativeTriangleRenderer:
    """Native multithreaded TRIANGLE-scene renderer.

    The reference's CPU renderer is sphere-only (src/main.cpp:206-599);
    this extends the native tier so both scene families have three
    independent implementations (Pallas kernel, XLA oracle, C++).
    """

    cfg: object            # RenderConfig (scene_kind "triangle")
    scene: object          # TriangleScene
    tiles: np.ndarray      # (T, 2) int32
    num_threads: int = 0

    def __post_init__(self):
        self.lib = native_mod.load()
        self.tiles = np.ascontiguousarray(self.tiles, np.int32)
        soup = {k: np.asarray(v) for k, v in self.scene.soup().items()}
        cols = ["v1x", "v1y", "v1z", "e1x", "e1y", "e1z",
                "e2x", "e2y", "e2z", "nax", "nay", "naz"]
        base = np.stack([soup[c] for c in cols], axis=1)
        dnb = np.stack([soup[f"nb{a}"] - soup[f"na{a}"] for a in "xyz"],
                       axis=1)
        dnc = np.stack([soup[f"nc{a}"] - soup[f"na{a}"] for a in "xyz"],
                       axis=1)
        self.tri_data = np.ascontiguousarray(
            np.concatenate([base, dnb, dnc], axis=1), np.float32)
        self.mesh_ids = np.ascontiguousarray(soup["mesh_id"], np.int32)
        cfg = self.cfg
        if getattr(cfg, "fog_density", 0.0) > 0.0:
            raise ValueError("the native renderer does not implement fog "
                             "(its threefry stream layout has no "
                             "collision-distance draws)")
        from l2n.rng.sampler import max_pairs_per_sample
        self._c = _CConfig(
            width=cfg.width, height=cfg.height,
            buf_width=cfg.padded_width, buf_height=cfg.padded_height,
            tile_width=cfg.tile_width, tile_height=cfg.tile_height,
            max_bounces=cfg.max_bounces,
            emissive_every=cfg.emissive_every,
            emission_scale=cfg.emission_scale,
            rr_ceiling=cfg.rr_ceiling,
            ray_epsilon=cfg.ray_epsilon,
            env_mode=_ENV_MODES[cfg.env_mode],
            env_scale=cfg.env_scale,
            gamma=cfg.gamma,
            rng_mode=_RNG_MODES[cfg.rng],
            seed=cfg.seed, stream=0,
            max_pairs=max_pairs_per_sample(cfg.max_bounces, cfg.nee),
            ray_gen=_RAY_GEN[cfg.ray_gen],
            aov=_AOVS.get(cfg.aov, 0),
            nee=int(cfg.nee),
            normal_map=getattr(cfg, "normal_map", 0.0),
            normal_map_freq=getattr(cfg, "normal_map_freq", 0.35),
            material_mode=_material_mode(cfg, sphere=False),
        )
        # Cone NEE (ops/nee.py) needs the per-mesh bounding spheres; use
        # the oracle's so both implementations sample identical cones.
        if cfg.nee:
            from l2n.scene.tessellate import mesh_bounds
            bounds = mesh_bounds(self.scene)
            self.mesh_bounds = np.ascontiguousarray(bounds, np.float32)
        else:
            self.mesh_bounds = None

    def render_tiles(self, accum: np.ndarray, output: np.ndarray,
                     camera_packed: np.ndarray, offset: int, count: int,
                     rng_state: np.ndarray | None = None) -> None:
        accum_c = np.ascontiguousarray(accum, np.float32)
        out_c = np.ascontiguousarray(output, np.float32)
        cam = _f32(camera_packed)
        if self._c.rng_mode == 1:
            if rng_state is None:
                raise ValueError("tinymt mode needs rng_state planes")
            rng_c = np.ascontiguousarray(rng_state, np.uint32)
            rng_ptr = rng_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        else:
            rng_c = None
            rng_ptr = None
        rc = self.lib.l2n_render_tiles_tri(
            ctypes.byref(self._c),
            self.tri_data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.mesh_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(self.tri_data.shape[0]),
            cam.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(self.tiles.shape[0]),
            ctypes.c_int32(offset), ctypes.c_int32(count),
            accum_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rng_ptr, ctypes.c_int32(self.num_threads),
            (self.mesh_bounds.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
             if self.mesh_bounds is not None else None),
            ctypes.c_int32(int(self.scene.mesh_count)))
        if rc != 0:
            raise RuntimeError(f"native triangle render failed: {rc}")
        accum[...] = accum_c
        output[...] = out_c
        if rng_c is not None:
            rng_state[...] = rng_c
