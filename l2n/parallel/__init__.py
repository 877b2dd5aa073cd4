"""Multi-chip scaling over a jax.sharding.Mesh.

The reference is single-process/single-GPU (SURVEY §2: no MPI/NCCL/IPC
anywhere); its parallelism axes are SIMT-over-pixels and progressive
accumulation over time. The first-class analogs here:

  * "tile" axis  — the framebuffer is sharded into row slabs, one per chip;
    sampling is embarrassingly parallel (zero inter-chip traffic while
    rendering, matching the reference's independent-pixel invariant);
  * "sample" axis — replicas render the same slab with decorrelated RNG
    streams; their accumulations fold with a `psum` (the one real
    collective) so the display converges n_sample times faster per step.

Together they form the renderer's DP/SP equivalent of a sharded training
step; `build_sharded_step` is what `__graft_entry__.dryrun_multichip`
compiles over a virtual mesh.
"""

from l2n.parallel.mesh import make_device_mesh, mesh_factors  # noqa: F401
from l2n.parallel.step import ShardedRenderer, build_sharded_step, init_sharded_state  # noqa: F401
