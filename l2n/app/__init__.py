"""Application layer: the frame loop without a GL window.

The reference's `l2n::Application` (GLFW window + ImGui,
l2n-renderer/src/main.cpp:108-1015) becomes a host loop around the jitted
render step with pluggable displays: PNG frame sequences (headless), an
ANSI terminal preview, or a matplotlib window when available.
"""

from l2n.app.application import Application  # noqa: F401
from l2n.app.display import AnsiDisplay, PngSequenceDisplay  # noqa: F401
