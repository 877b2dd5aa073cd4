"""Render-session checkpointing.

The reference persists exactly one thing across runs — the camera pose in
`l2n_cache.json` (src/main.cpp:794-816,1004-1012) — and keeps the in-session
render state (accum texture + RNG states + tile offset) resumable only
within a run (SURVEY §5 checkpoint/resume). Here both tiers exist:

  * the camera JSON cache (l2n.camera.cache), file-compatible;
  * full session checkpoints: one NPZ holding the FrameState planes plus
    config and camera, so a progressive render resumes bit-exactly across
    process restarts (counter-based RNG makes this trivial — the "RNG
    state" is the per-pixel sample count already in accum[3]).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from l2n.config import RenderConfig
from l2n.render.state import FrameState


def save_session(path: str | Path, cfg: RenderConfig, state: FrameState,
                 view_matrix: np.ndarray) -> Path:
    path = Path(path)
    arrays = {
        "accum": np.asarray(state.accum),
        "output": np.asarray(state.output),
        "tile_offset": np.asarray(state.tile_offset),
        "iteration": np.asarray(state.iteration),
        "view_matrix": np.asarray(view_matrix, np.float32),
    }
    if state.rng_state is not None:
        arrays["rng_state"] = np.asarray(state.rng_state)
    np.savez_compressed(path, config=np.frombuffer(
        cfg.to_json().encode(), dtype=np.uint8), **arrays)
    return path


def load_session(path: str | Path) -> tuple[RenderConfig, FrameState, np.ndarray]:
    with np.load(Path(path)) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        state = FrameState(
            accum=jnp.asarray(data["accum"]),
            output=jnp.asarray(data["output"]),
            tile_offset=jnp.int32(data["tile_offset"]),
            iteration=jnp.int32(data["iteration"]),
            rng_state=(jnp.asarray(data["rng_state"])
                       if "rng_state" in data else None),
        )
        view = data["view_matrix"]
    return cfg, state, view


def save_sharded_session(path: str | Path, cfg: RenderConfig, state,
                         view_matrix: np.ndarray | None = None) -> Path:
    """Checkpoint a multi-device ShardedFrameState (l2n.parallel.step).

    The sample-axis accum replicas are gathered and saved per replica so a
    resume continues each replica's exact sample numbering (it depends only
    on the replica's mesh coordinate and count, which the loading mesh
    re-establishes).
    """
    path = Path(path)
    arrays = {
        "sharded_accum": np.asarray(state.accum),
        "output": np.asarray(state.output),
        "tile_offset": np.asarray(state.tile_offset),
        "iteration": np.asarray(state.iteration),
    }
    if state.rng_state is not None:
        # Stateful parity modes: the per-pixel streams ARE the state —
        # resuming without them would restart every pixel's sequence.
        arrays["rng_state"] = np.asarray(state.rng_state)
    if view_matrix is not None:
        arrays["view_matrix"] = np.asarray(view_matrix, np.float32)
    np.savez_compressed(path, config=np.frombuffer(
        cfg.to_json().encode(), dtype=np.uint8), **arrays)
    return path


def load_sharded_session(path: str | Path, mesh):
    """Load a sharded session onto `mesh` (re-sharding the planes the same
    way init_sharded_state lays them out). Returns (cfg, ShardedFrameState,
    view_matrix or None)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from l2n.parallel.step import ShardedFrameState

    with np.load(Path(path)) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        accum_np = data["sharded_accum"]
        if accum_np.shape[0] != mesh.shape["sample"]:
            raise ValueError(
                f"session has {accum_np.shape[0]} sample replicas; mesh has "
                f"{mesh.shape['sample']}")
        accum = jax.device_put(
            jnp.asarray(accum_np),
            NamedSharding(mesh, P("sample", None, "tile", None)))
        output = jax.device_put(
            jnp.asarray(data["output"]),
            NamedSharding(mesh, P(None, "tile", None)))
        rng_state = None
        if "rng_state" in data:
            rng_state = jax.device_put(
                jnp.asarray(data["rng_state"]),
                NamedSharding(mesh, P(None, "tile", None)))
        state = ShardedFrameState(
            accum=accum, output=output,
            tile_offset=jnp.int32(data["tile_offset"]),
            iteration=jnp.int32(data["iteration"]),
            rng_state=rng_state)
        view = data["view_matrix"] if "view_matrix" in data else None
    return cfg, state, view
