"""The sharded render step: shard_map over the ("tile", "sample") mesh.

Sharding layout (the renderer's analog of a dp/sp-sharded training step):

  accum   (n_sample, 4, Hp, Wp)  P("sample", None, "tile", None)
  output  (3, Hp, Wp)            P(None, "tile", None)
  rng     (S, Hp, Wp) u32        P(None, "tile", None) — stateful parity
                                 modes only (per-pixel streams live with
                                 their slab; sample axis must be 1)
  camera / tile offset           replicated
  tile schedules (n_tile, T, 2)  P("tile", None, None) — one shuffled
                                 schedule per row slab

Each device renders `tiles_per_step` tiles of its own slab per step (the
reference's scheduler, applied per slab — src/main.cpp:830-852); sample
replica r of n draws global sample numbers count * n + r, so the folded
estimate equals a single device's at n * spp. The only collective is the
`psum` folding sample-axis accumulations into the display estimate; slab
rendering itself is communication-free, preserving the reference's
independent-pixel design (SURVEY §5 "distributed communication backend").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from l2n.config import RenderConfig
from l2n.render.state import FrameState
from l2n.render.step import _xla_step, default_backend, make_intersector
from l2n.render.tiles import scheduled_pixel_mask, tile_grid


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedFrameState:
    accum: jnp.ndarray        # (n_sample, 4, Hp, Wp)
    output: jnp.ndarray       # (3, Hp, Wp)
    tile_offset: jnp.ndarray  # () i32
    iteration: jnp.ndarray    # () i32
    # Per-pixel RNG state planes for the stateful parity modes (tinymt /
    # tauslcg): (S, Hp, Wp) u32, sharded P(None, "tile", None) — each
    # pixel's stream lives with its slab. None under stateless samplers.
    rng_state: jnp.ndarray | None = None


def slab_tile_grids(cfg: RenderConfig, n_tile: int) -> np.ndarray:
    """(n_tile, T_local, 2) int32: an independently shuffled schedule per
    row slab (slab-local tile coordinates)."""
    if cfg.tile_count_y % n_tile != 0:
        raise ValueError(
            f"tile rows {cfg.tile_count_y} not divisible by tile axis {n_tile}")
    rows_per = cfg.tile_count_y // n_tile
    slab_cfg = cfg.replace(height=rows_per * cfg.tile_height)
    grids = []
    for s in range(n_tile):
        grids.append(tile_grid(slab_cfg.replace(
            tile_shuffle_seed=cfg.tile_shuffle_seed + s)))
    return np.stack(grids).astype(np.int32)


def init_sharded_state(cfg: RenderConfig, mesh: Mesh) -> ShardedFrameState:
    n_sample = mesh.shape["sample"]
    hp, wp = cfg.padded_height, cfg.padded_width
    rng_state = None
    if cfg.rng_stateful:
        # The reference assigns exactly ONE stream per pixel
        # (computeTinyMTStateVector, src/main.cpp:859-878); a sample axis
        # would have replicas retrace identical streams. Row slabs are
        # fine: the per-pixel planes are global-image functions sliced by
        # row, so sharding them alongside the framebuffer changes nothing.
        if n_sample != 1:
            raise ValueError(
                "stateful parity samplers (tinymt/tauslcg) shard over "
                "'tile' only: the reference's streams are per-pixel, so "
                "sample-axis replicas would duplicate them — use "
                "mesh sample=1 or a stateless sampler")
        from l2n.render.state import init_frame_state
        rng_state = jax.device_put(
            init_frame_state(cfg).rng_state,
            NamedSharding(mesh, P(None, "tile", None)))
    accum = jax.device_put(
        jnp.zeros((n_sample, 4, hp, wp), jnp.float32),
        NamedSharding(mesh, P("sample", None, "tile", None)))
    output = jax.device_put(
        jnp.zeros((3, hp, wp), jnp.float32),
        NamedSharding(mesh, P(None, "tile", None)))
    return ShardedFrameState(accum=accum, output=output,
                             tile_offset=jnp.int32(0), iteration=jnp.int32(0),
                             rng_state=rng_state)


def build_sharded_step(cfg: RenderConfig, scene, mesh: Mesh,
                       donate: bool = True, backend: str = "auto",
                       interpret: bool = False):
    """step(ShardedFrameState, packed_camera) -> ShardedFrameState, jitted
    over the mesh.

    backend "pallas" runs the fused sphere kernel per shard inside the
    shard_map; "xla" runs the oracle step; "auto" is
    `render.step.default_backend`. `interpret=True` runs the kernel in the
    Pallas interpreter (tests on the virtual CPU mesh).
    """
    cfg.validate()
    if backend == "auto":
        backend = default_backend(cfg)
    n_tile, n_sample = mesh.shape["tile"], mesh.shape["sample"]
    intersect, miss_color, light_sampler, anyhit = make_intersector(cfg, scene)
    tile_grids = jnp.asarray(slab_tile_grids(cfg, n_tile))
    k = cfg.effective_tiles_per_step
    rows_per_slab = cfg.padded_height // n_tile

    pallas_call_local = None
    if backend == "pallas":
        if cfg.scene_kind != "sphere":
            raise ValueError("the pallas kernel renders sphere scenes only")
        # The per-shard kernel renders a slab-sized framebuffer; ray
        # generation still maps pixels against the full image.
        from l2n.ops.kernels.sphere_pt import build_sphere_call
        slab_cfg = cfg.replace(height=rows_per_slab,
                               ndc_height=cfg.ndc_height or cfg.height)
        pallas_call_local = build_sphere_call(
            slab_cfg, scene, interpret=interpret,
            sample_stride=n_sample)
        spheres = tuple(jnp.asarray(a) for a in (
            scene.center_x, scene.center_y, scene.center_z,
            scene.sqr_radius))
    elif backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")

    def _pallas_local_step(tiles_l, local, camera, row_offset, sample_rank):
        from l2n.camera.camera import ROW_PROJ
        from l2n.render.tiles import scheduled_tiles
        cam = camera.at[ROW_PROJ, 2].set(row_offset.astype(jnp.float32))
        cam = cam.at[ROW_PROJ, 3].set(sample_rank.astype(jnp.float32))
        sched = scheduled_tiles(tiles_l, local.tile_offset, k)
        args = [sched, cam, *spheres, local.accum, local.output]
        if stateful:
            # Per-pixel state planes ride with their slab exactly as in the
            # single-device kernel step: appended input, third output,
            # aliased in the call.
            args.append(local.rng_state)
        outs = pallas_call_local(*args)
        return FrameState(
            accum=outs[0], output=outs[1],
            tile_offset=(local.tile_offset + jnp.int32(k))
            % jnp.int32(tiles_l.shape[0]),
            iteration=local.iteration + 1,
            rng_state=outs[2] if stateful else None)

    stateful = cfg.rng_stateful

    def body(tiles_l, accum_l, out_l, rng_l, offset, iteration, camera):
        # Local views: tiles_l (1, T, 2), accum_l (1, 4, hl, Wp),
        # out_l (3, hl, Wp), rng_l (S, hl, Wp) or a (1, 1, 1) placeholder
        # for stateless modes.
        tile_rank = jax.lax.axis_index("tile")
        sample_rank = jax.lax.axis_index("sample")
        local = FrameState(accum=accum_l[0], output=out_l,
                           tile_offset=offset, iteration=iteration,
                           rng_state=rng_l if stateful else None)
        # Slabs own distinct pixels (the global pixel index keys the
        # draws); sample replicas interleave one sample numbering, so no
        # cross-device coordination is needed and the folded estimate is
        # the one a single device takes at n_sample * spp. (Stateful modes
        # ignore it — their streams are the per-pixel state planes,
        # slab-local like the framebuffer.)
        if backend == "pallas":
            new = _pallas_local_step(tiles_l[0], local, camera,
                                     tile_rank * rows_per_slab, sample_rank)
        else:
            new = _xla_step(cfg, intersect, miss_color, tiles_l[0], local,
                            camera, row_offset=tile_rank * rows_per_slab,
                            sample_rank=sample_rank, sample_stride=n_sample,
                            light_sampler=light_sampler,
                            intersect_anyhit=anyhit)
        # Fold the sample axis (the one collective) and re-tonemap scheduled
        # pixels so the display uses all n_sample estimates.
        folded = jax.lax.psum(new.accum, "sample")
        mask = scheduled_pixel_mask(cfg, tiles_l[0], offset, k,
                                    height=rows_per_slab)
        display = jnp.power(
            jnp.maximum(folded[:3], 0.0)
            / jnp.maximum(folded[3:4], jnp.float32(1e-20)),
            jnp.float32(cfg.gamma))
        out = jnp.where(mask[None], display, out_l)
        new_rng = new.rng_state if stateful else rng_l
        return new.accum[None], out, new_rng, new.tile_offset, new.iteration

    shard = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("tile", None, None),
                  P("sample", None, "tile", None),
                  P(None, "tile", None),
                  P(None, "tile", None) if stateful else P(),
                  P(), P(), P()),
        out_specs=(P("sample", None, "tile", None), P(None, "tile", None),
                   P(None, "tile", None) if stateful else P(),
                   P(), P()),
        check_vma=False,
    )

    rng_placeholder = jnp.zeros((1, 1, 1), jnp.uint32)

    def jit_body(state: ShardedFrameState, camera):
        accum, output, rng_state, offset, iteration = shard(
            tile_grids, state.accum, state.output,
            state.rng_state if stateful else rng_placeholder,
            state.tile_offset, state.iteration, camera)
        return ShardedFrameState(accum=accum, output=output,
                                 tile_offset=offset, iteration=iteration,
                                 rng_state=rng_state if stateful else None)

    return jax.jit(jit_body, donate_argnums=(0,) if donate else ())


class ShardedRenderer:
    """Host-side driver for multi-chip progressive rendering."""

    def __init__(self, cfg: RenderConfig, scene, mesh: Mesh,
                 backend: str = "auto", interpret: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.step_fn = build_sharded_step(cfg, scene, mesh, backend=backend,
                                          interpret=interpret)
        self.state = init_sharded_state(cfg, mesh)

    def step(self, camera) -> ShardedFrameState:
        self.state = self.step_fn(self.state, camera.packed())
        return self.state

    def clear(self) -> None:
        self.state = dataclasses.replace(
            self.state, accum=jnp.zeros_like(self.state.accum))

    def display(self) -> np.ndarray:
        """Gather the sharded display planes to the host — the multi-device
        framebuffer blit (a gather instead of glBlitFramebuffer)."""
        img = np.asarray(self.state.output[:, :self.cfg.height, :self.cfg.width])
        return np.moveaxis(img, 0, -1)

    def save_session(self, path, view_matrix=None):
        """Multi-chip progressive renders checkpoint too: gather + NPZ."""
        from l2n.utils.checkpoint import save_sharded_session
        return save_sharded_session(path, self.cfg, self.state, view_matrix)

    def load_session(self, path):
        from l2n.utils.checkpoint import load_sharded_session
        cfg, state, view = load_sharded_session(path, self.mesh)
        if cfg != self.cfg:
            raise ValueError("session config does not match renderer config")
        self.state = state
        return view
