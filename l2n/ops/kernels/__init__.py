"""Hand-written GPU kernels — the analog of the reference's GLSL compute
shaders (l2n-renderer/src/shaders/*.cs.glsl).

`sphere_pt` is the fused per-pixel sphere path tracer (Pallas through
Triton). Triangle and OBJ scenes render through the XLA oracle
(`render/step.py`).
"""
