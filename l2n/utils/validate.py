"""Runtime validation layer.

The reference's only runtime checking is the synchronous GL debug context
(src/main.cpp:160-162) — an API sanitizer (SURVEY §4.2/§5). Equivalents
here:

  * `check_frame_state` — NaN/Inf audit of the frame state planes (the
    progressive estimator must stay finite; a NaN accumulates forever);
  * `debug_mode()` — context manager enabling jax NaN debugging; build
    programs with `interpret=True` inside it to step through the kernel in
    the Pallas interpreter (never implied);
  * `rmse_vs_oracle` — the formalized dual-implementation oracle check
    (SURVEY §4.1): runs any backend against the full-frame XLA oracle on the
    same seeds and reports per-sample statistics, the metric the accuracy
    gate (per-sample RMSE < 1e-3) is expressed in.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import jax


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    nan_count: int
    inf_count: int
    negative_samples: int  # accum sample counts must never go negative

    @property
    def ok(self) -> bool:
        return self.nan_count == 0 and self.inf_count == 0 \
            and self.negative_samples == 0


def check_frame_state(state) -> ValidationReport:
    """Audit accum/output planes for non-finite values."""
    nans = infs = 0
    for plane in (state.accum, state.output):
        arr = np.asarray(plane)
        nans += int(np.isnan(arr).sum())
        infs += int(np.isinf(arr).sum())
    neg = int((np.asarray(state.accum[3]) < 0).sum())
    return ValidationReport(nan_count=nans, inf_count=infs,
                            negative_samples=neg)


@contextlib.contextmanager
def debug_mode():
    """NaN checking for everything run inside."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def rmse_vs_oracle(cfg, scene, steps: int = 4, backend: str = "pallas",
                   camera=None, interpret: bool = False) -> dict:
    """Render `steps` with `backend` and the XLA oracle on identical seeds;
    return parity statistics: per-sample radiance (accum rgb / count)
    RMSE and max-abs, the fraction of pixels whose per-sample value
    differs by more than 1e-3, whether the sample counts match, and for
    stateful samplers whether the stepped RNG planes are identical."""
    from l2n.camera import Camera
    from l2n.render.state import init_frame_state
    from l2n.render.step import build_render_step

    camera = camera or Camera.from_config(cfg)
    packed = camera.packed()
    test_step = build_render_step(cfg, scene, backend=backend,
                                  interpret=interpret)
    oracle_step = build_render_step(cfg, scene, backend="xla")
    st_a, st_b = init_frame_state(cfg), init_frame_state(cfg)
    for _ in range(steps):
        st_a = test_step(st_a, packed)
        st_b = oracle_step(st_b, packed)
    h, w = cfg.height, cfg.width  # crop the tile padding
    a = np.asarray(st_a.accum, np.float64)[:, :h, :w]
    b = np.asarray(st_b.accum, np.float64)[:, :h, :w]
    diff = np.abs(a[:3] / np.maximum(a[3], 1.0)
                  - b[:3] / np.maximum(b[3], 1.0))
    rng_match = None
    if cfg.rng_stateful:
        rng_match = bool(np.array_equal(np.asarray(st_a.rng_state),
                                        np.asarray(st_b.rng_state)))
    return {
        "rmse": float(np.sqrt((diff ** 2).mean())),
        "max_abs": float(diff.max()),
        "diverging_fraction": float((diff.max(0) > 1e-3).mean()),
        "coverage_match": bool((a[3] == b[3]).all()),
        "rng_match": rng_match,
        "finite": bool(np.isfinite(a).all()),
        "lit_fraction": float((a[:3].max(0) > 0).mean()),
    }
