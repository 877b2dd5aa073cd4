"""Camera layer: uniforms, FPS view controller, JSON pose persistence."""

from l2n.camera.camera import Camera  # noqa: F401
from l2n.camera.view_controller import ViewController, ControllerInput  # noqa: F401
from l2n.camera.cache import load_view_matrix, save_view_matrix  # noqa: F401
