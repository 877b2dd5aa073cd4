"""Device ops: intersection, environment lights, path tracing.

Everything here is written in structure-of-arrays component form over
arbitrary-shaped lane arrays, so the same tracing code runs (a) as the
vectorized pure-XLA *oracle* renderer — the analog of the reference's CPU
renderer used as a test oracle (l2n-renderer/src/main.cpp:206-599) — and
(b) inside the Pallas kernel over pixel blocks (`l2n.ops.kernels`).
"""

from l2n.ops import envlight, intersect, pathtrace  # noqa: F401
