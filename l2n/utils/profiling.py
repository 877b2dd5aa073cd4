"""Profiling and structured metrics.

The reference's only performance surface is the ImGui ms/frame readout
(src/main.cpp:973) fed by glfwGetTime bracketing (SURVEY §5). Here:
step timing + throughput counters (`StepTimer`) and on-demand
`jax.profiler` traces (`trace`) for real device timelines.
"""

from __future__ import annotations

import contextlib
import logging
import time

_log = logging.getLogger("l2n.metrics")


class StepTimer:
    """Rolling per-step wall-clock and derived throughput counters."""

    def __init__(self, window: int = 120):
        self.window = window
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > 2 * self.window:
            del self.times[:self.window]

    def metrics(self, samples_per_step: int, pixels: int,
                mean_segments: float = 1.0) -> dict[str, float]:
        times = self.times[-self.window:] or [float("nan")]
        ms = sum(times) / len(times) * 1e3
        sps = samples_per_step / (ms * 1e-3)
        return {
            "ms_per_step": ms,
            "fps": 1e3 / ms,
            "samples_per_sec": sps,
            "spp_per_sec": sps / pixels,
            "mrays_per_sec": sps * mean_segments / 1e6,
        }


def log_metrics(step: int, metrics: dict[str, float]) -> None:
    _log.info("step=%d %s", step,
              " ".join(f"{k}={v:.3f}" for k, v in metrics.items()))


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/l2n_trace"):
    """jax.profiler trace around a block (view with tensorboard/xprof)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
