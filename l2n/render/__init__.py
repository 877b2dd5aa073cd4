"""Progressive render machinery: tile scheduling, frame state, render step.

Functional rewrite of the reference's mutable GL render state — accum
texture, output image, per-pixel RNG buffer, tile offset
(l2n-renderer/src/main.cpp:830-948): everything lives in an immutable
`FrameState` pytree threaded through a jitted, buffer-donating render step.
"""

from l2n.render.tiles import tile_grid, advance_offset  # noqa: F401
from l2n.render.state import FrameState, init_frame_state, clear_accumulation  # noqa: F401
from l2n.render.step import build_render_step  # noqa: F401
from l2n.render.program import (  # noqa: F401
    PathtracingProgram,
    SphereProgram,
    TriangleProgram,
)
from l2n.render.renderer import Renderer  # noqa: F401
