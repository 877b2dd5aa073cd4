"""Renderer: owns frame state + programs, drives progressive steps.

The host-side equivalent of the reference's frame loop state (current
program pointer, clear-on-switch, clear-on-move, iteration counter —
l2n-renderer/src/main.cpp:899-1001) without the windowing: the
application layer calls `step()` once per frame and reads `display()`.
"""

from __future__ import annotations

import time

import numpy as np

from l2n.camera.camera import Camera
from l2n.config import RenderConfig
from l2n.render.program import PathtracingProgram
from l2n.render.state import FrameState, clear_accumulation, init_frame_state


class Renderer:
    def __init__(self, programs: dict[str, PathtracingProgram],
                 current: str | None = None):
        if not programs:
            raise ValueError("need at least one program")
        self.programs = programs
        self.current = current or next(iter(programs))
        self.state: FrameState = init_frame_state(self.program.cfg)
        self._step_times: list[float] = []
        self._warm: set[str] = set()

    @property
    def program(self) -> PathtracingProgram:
        return self.programs[self.current]

    @property
    def cfg(self) -> RenderConfig:
        return self.program.cfg

    def switch(self, name: str) -> None:
        """Renderer combo switch => clear accumulation (main.cpp:977-980)."""
        if name not in self.programs:
            raise KeyError(name)
        if name != self.current:
            self.current = name
            self.state = clear_accumulation(self.state)

    def on_camera_moved(self) -> None:
        """Camera moved => clear accumulation (main.cpp:999-1001)."""
        self.state = clear_accumulation(self.state)

    def step(self, camera: Camera, block: bool = False) -> FrameState:
        t0 = time.perf_counter()
        self.state = self.program.step(self.state, camera.packed())
        if block:
            self.state.output.block_until_ready()
        if self.current in self._warm:
            self._step_times.append(time.perf_counter() - t0)
        else:
            # First call of a program pays XLA/Triton compilation — keep it
            # out of the rolling throughput stats.
            self._warm.add(self.current)
        if len(self._step_times) > 240:
            del self._step_times[:120]
        return self.state

    def display(self) -> np.ndarray:
        """(H, W, 3) float32 tonemapped image, host-side and cropped to the
        visible area. The only per-frame readback, like the reference's
        framebuffer blit (main.cpp:959-965)."""
        from l2n.render.state import display_image
        return display_image(self.cfg, self.state)

    # -- metrics (the ImGui ms/frame readout analog, main.cpp:973) ----------
    def metrics(self) -> dict[str, float]:
        cfg = self.cfg
        times = self._step_times[-120:] or [float("nan")]
        ms = float(np.mean(times)) * 1e3
        pixels_per_step = (cfg.effective_tiles_per_step
                           * cfg.tile_height * cfg.tile_width)
        spp_per_sec = (pixels_per_step / (ms * 1e-3)) / (cfg.width * cfg.height)
        return {
            "ms_per_step": ms,
            "fps": 1e3 / ms if ms > 0 else float("nan"),
            "samples_per_sec": pixels_per_step / (ms * 1e-3),
            "spp_per_sec": spp_per_sec,
            "iteration": int(self.state.iteration),
        }
