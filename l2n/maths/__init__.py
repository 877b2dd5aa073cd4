"""Math layer: host-side camera/matrix helpers and device-side SoA helpers.

Analog of the reference's `c2ba-maths` submodule (types float2/3/4,
float4x4, lookAt, perspective, rotate, inverse — included at
l2n-renderer/src/main.cpp:8-26).

Host matrix math (`linalg`) is numpy float32 — it runs once per frame on the
host to produce camera uniforms. Device math (`sampling`) is jax.numpy in
structure-of-arrays component form so the same functions trace inside Pallas
kernels and in the vectorized oracle renderer.
"""

from l2n.maths import linalg, sampling  # noqa: F401
