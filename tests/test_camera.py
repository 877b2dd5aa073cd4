"""Camera tests: view controller semantics, pose cache, packed uniforms
(reference: src/ViewController.cpp, src/main.cpp:794-816,1004-1012)."""

import json

import numpy as np
import pytest

from l2n.camera import (
    Camera,
    ControllerInput,
    ViewController,
    load_view_matrix,
    save_view_matrix,
)
from l2n.camera import camera as camera_mod
from l2n.config import RenderConfig
from l2n.maths.linalg import DEFAULT_VIEW_MATRIX, camera_position, inverse


class TestViewController:
    def test_no_input_no_move(self):
        vc = ViewController(speed=10.0)
        assert vc.update(ControllerInput(), 0.016) is False

    def test_forward_moves_along_front(self):
        vc = ViewController(speed=10.0, view_matrix=np.eye(4, dtype=np.float32))
        moved = vc.update(ControllerInput(forward=True), 1.0)
        assert moved
        pos = camera_position(vc.rcp_view_matrix)
        # Identity view faces -z; speed 10 * dt 1 => z -= 10.
        np.testing.assert_allclose(pos, [0, 0, -10], atol=1e-4)

    def test_strafe_and_vertical(self):
        vc = ViewController(speed=2.0, view_matrix=np.eye(4, dtype=np.float32))
        vc.update(ControllerInput(left=True, up=True), 1.0)
        pos = camera_position(vc.rcp_view_matrix)
        np.testing.assert_allclose(pos, [-2, 2, 0], atol=1e-4)

    def test_opposed_keys_cancel(self):
        vc = ViewController(speed=5.0, view_matrix=np.eye(4, dtype=np.float32))
        moved = vc.update(ControllerInput(forward=True, backward=True), 1.0)
        # Translation cancels to zero — but the reference still reports
        # moved=False only when the vector is exactly zero (VC.cpp:55-57).
        assert moved is False

    def test_mouse_yaw(self):
        vc = ViewController(speed=1.0, view_matrix=np.eye(4, dtype=np.float32))
        moved = vc.update(ControllerInput(dragging=True, cursor_dx=10.0), 0.016)
        assert moved
        front = -vc.rcp_view_matrix[:3, 2]
        # rotate(-0.01*dx, +y) (VC.cpp:83): forward -z turns toward +x
        # (drag right => look right).
        assert abs(front[1]) < 1e-5
        assert front[0] == pytest.approx(np.sin(0.1), abs=1e-3)
        assert front[2] == pytest.approx(-np.cos(0.1), abs=1e-3)

    def test_roll_fixed_rate(self):
        vc = ViewController(speed=1.0, view_matrix=np.eye(4, dtype=np.float32))
        vc.update(ControllerInput(roll_left=True), 123.0)  # dt-independent
        up = vc.rcp_view_matrix[:3, 1]
        assert up[0] == pytest.approx(-np.sin(0.01), abs=1e-4)

    def test_speed_knobs(self):
        vc = ViewController(speed=1.0)
        vc.increase_speed(2.0)
        assert vc.speed == 3.0
        vc.increase_speed(-10.0)
        assert vc.speed == 0.0  # clamped (ViewController.hpp:27-30)

    def test_view_matrix_inverse_consistency(self):
        vc = ViewController(speed=1.0)
        vc.update(ControllerInput(forward=True, dragging=True,
                                  cursor_dx=5, cursor_dy=-3), 0.1)
        np.testing.assert_allclose(
            vc.rcp_view_matrix @ vc.view_matrix, np.eye(4), atol=1e-4)


class TestCache:
    def test_roundtrip(self, tmp_path):
        vc = ViewController(speed=1.0)
        vc.update(ControllerInput(forward=True), 0.5)
        save_view_matrix(vc.view_matrix, tmp_path)
        loaded = load_view_matrix(tmp_path)
        np.testing.assert_allclose(loaded, vc.view_matrix, atol=1e-6)

    def test_missing_falls_back_to_default(self, tmp_path):
        np.testing.assert_array_equal(load_view_matrix(tmp_path),
                                      DEFAULT_VIEW_MATRIX)

    def test_corrupt_falls_back(self, tmp_path):
        (tmp_path / "l2n_cache.json").write_text("{not json")
        np.testing.assert_array_equal(load_view_matrix(tmp_path),
                                      DEFAULT_VIEW_MATRIX)

    def test_on_disk_format_is_reference_compatible(self, tmp_path):
        """16-float `view_matrix` key, column-major order (main.cpp:1004-1012)."""
        save_view_matrix(DEFAULT_VIEW_MATRIX, tmp_path)
        data = json.loads((tmp_path / "l2n_cache.json").read_text())
        assert len(data["view_matrix"]) == 16
        # Column-major: first 4 entries are the first column.
        np.testing.assert_allclose(data["view_matrix"][:4],
                                   DEFAULT_VIEW_MATRIX[:, 0], atol=1e-6)


class TestPackedCamera:
    def test_layout(self):
        cfg = RenderConfig().validate()
        cam = Camera.from_config(cfg)
        p = cam.packed()
        assert p.shape == camera_mod.PACKED_SHAPE
        np.testing.assert_allclose(p[camera_mod.ROW_RCP_VIEW:4],
                                   inverse(cam.view_matrix), atol=1e-6)
        np.testing.assert_allclose(p[camera_mod.ROW_POSITION, :3],
                                   cam.position, atol=1e-6)
        assert p[camera_mod.ROW_PROJ, 0] == pytest.approx(1280 / 720)
        assert p[camera_mod.ROW_PROJ, 1] == pytest.approx(
            np.tan(np.radians(22.5)), rel=1e-5)

    def test_default_pose_matches_reference(self):
        cam = Camera.from_config(RenderConfig().validate())
        # Hard-coded fallback (main.cpp:805-809).
        assert cam.view_matrix[0, 3] == pytest.approx(12.503)
        assert cam.view_matrix[2, 3] == pytest.approx(-325.982)
