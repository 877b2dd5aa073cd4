"""l2n — a progressive Monte-Carlo path-tracing framework for GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``Celeborn2BeAlive/l2n-renderer`` ("Les Lumières de Noël", cited below as
``l2n-renderer/<path>:<line>``): a progressive path tracer over procedural sphere and
tessellated triangle scenes, with tile-scheduled progressive accumulation,
swappable RNG modules, an FPS camera controller with JSON persistence, and
dual (kernel vs. oracle) implementations used as each other's test oracle.

Design:
  * the per-pixel GLSL sphere compute shader becomes one fused Pallas kernel
    compiled through Triton, the path state kept in registers (reference:
    src/shaders/sphere_pathtracing.cs.glsl);
  * per-pixel mutable TinyMT32 streams become counter-based threefry keyed on
    (pixel, sample, draw) — stateless and bit-reproducible (a bit-exact
    TinyMT32 port is kept as a parity mode, reference: src/tinymt32.{hpp,cpp});
  * the divergent SIMT ``while`` path loop becomes a fixed-depth unrolled loop
    with alive/Russian-roulette masks (lane-lockstep);
  * mutable GL buffers (accum texture, RNG states, tile offset) become a
    functional ``FrameState`` threaded through a jitted, donated render step;
  * multi-chip scaling is ``shard_map`` over a ``jax.sharding.Mesh`` — image
    tiles sharded across chips (no collectives while sampling) and an optional
    sample axis folded with ``psum``.
"""

__version__ = "0.1.0"

from l2n.config import RenderConfig  # noqa: F401
