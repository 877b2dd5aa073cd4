"""Application layer + checkpoint/session + image IO tests."""

import zlib

import numpy as np
import pytest

from l2n.app import Application, PngSequenceDisplay
from l2n.camera import ControllerInput
from l2n.config import RenderConfig
from l2n.utils.checkpoint import load_session, save_session
from l2n.utils.image import tonemap_to_u8, write_png

CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                   sphere_count=8, tiles_per_step=1).validate()


def make_app(tmp_path, cfg=CFG):
    return Application(cfg, workdir=tmp_path, backend="xla",
                       renderer_names=("spherePT",))


class TestApplication:
    def test_run_headless(self, tmp_path):
        app = make_app(tmp_path)
        disp = PngSequenceDisplay(tmp_path / "frames", every=2)
        state = app.run(4, display=disp)
        assert int(state.iteration) == 4
        assert len(list((tmp_path / "frames").glob("*.png"))) == 2
        # Camera cache written on exit (main.cpp:1004-1012).
        assert (tmp_path / "l2n_cache.json").exists()

    def test_camera_cache_roundtrip_across_apps(self, tmp_path):
        app = make_app(tmp_path)
        moves = {0: ControllerInput(forward=True)}
        app.run(2, input_source=lambda f: moves.get(f))
        pose = app.controller.view_matrix.copy()
        app2 = make_app(tmp_path)
        np.testing.assert_allclose(app2.controller.view_matrix, pose, atol=1e-6)

    def test_camera_move_clears_accum(self, tmp_path):
        app = make_app(tmp_path)
        app.run(1, input_source=lambda f: ControllerInput(forward=True),
                save_camera=False)
        # The clear happens after the step: accumulation was reset.
        assert np.asarray(app.renderer.state.accum).sum() == 0

    def test_renderer_switch(self, tmp_path):
        cfg = CFG.replace(disc_lat=8, disc_long=4)
        app = Application(cfg, workdir=tmp_path, backend="xla")
        app.run(1, save_camera=False)
        app.switch_renderer("trianglePT")
        assert np.asarray(app.renderer.state.accum).sum() == 0
        app.run(1, save_camera=False)
        assert np.asarray(app.renderer.state.accum[3]).sum() > 0


class TestSessionCheckpoint:
    def test_roundtrip_resumes_bit_exact(self, tmp_path):
        app = make_app(tmp_path)
        app.run(3, save_camera=False)
        path = app.save_session(tmp_path / "session.npz")

        resumed = make_app(tmp_path)
        resumed.load_session(path)
        cont_a = resumed.run(2, save_camera=False)

        ref = make_app(tmp_path)
        cont_b = ref.run(5, save_camera=False)
        np.testing.assert_array_equal(np.asarray(cont_a.accum),
                                      np.asarray(cont_b.accum))

    def test_config_mismatch_rejected(self, tmp_path):
        app = make_app(tmp_path)
        path = save_session(tmp_path / "s.npz", app.cfg, app.renderer.state,
                            app.controller.view_matrix)
        other = make_app(tmp_path, CFG.replace(seed=99))
        with pytest.raises(ValueError):
            other.load_session(path)

    def test_obj_scene_roundtrip(self, tmp_path):
        """Session checkpoints of OBJ renders record the scene source in
        the config (cfg.obj_path), so a resume rebuilds the SAME imported
        geometry — and resuming into a procedural-scene config is rejected
        instead of silently accumulating mismatched radiance."""
        from l2n.scene.procgen import torus_field_obj
        obj = tmp_path / "tori.obj"
        obj.write_text(torus_field_obj(n_tori=2, seg_u=8, seg_v=6,
                                       world_size=256.0))
        cfg = CFG.replace(scene_kind="triangle", obj_path=str(obj))
        app = Application(cfg, workdir=tmp_path, backend="xla",
                          renderer_names=("trianglePT",),
                          initial_renderer="trianglePT")
        app.run(2, save_camera=False)
        path = app.save_session(tmp_path / "obj_session.npz")

        resumed = Application(cfg, workdir=tmp_path, backend="xla",
                              renderer_names=("trianglePT",),
                              initial_renderer="trianglePT")
        # The resumed program rebuilt the imported scene from obj_path.
        np.testing.assert_array_equal(
            np.asarray(resumed.renderer.program.scene.vertices),
            np.asarray(app.renderer.program.scene.vertices))
        resumed.load_session(path)
        np.testing.assert_array_equal(
            np.asarray(resumed.renderer.state.accum),
            np.asarray(app.renderer.state.accum))

        plain = Application(CFG.replace(scene_kind="triangle", disc_lat=8,
                                        disc_long=4),
                            workdir=tmp_path, backend="xla",
                            renderer_names=("trianglePT",),
                            initial_renderer="trianglePT")
        with pytest.raises(ValueError):
            plain.load_session(path)

    def test_tinymt_state_checkpointed(self, tmp_path):
        cfg = CFG.replace(rng="tinymt")
        app = make_app(tmp_path, cfg)
        app.run(1, save_camera=False)
        path = app.save_session(tmp_path / "s.npz")
        _, state, _ = load_session(path)
        assert state.rng_state is not None
        np.testing.assert_array_equal(np.asarray(state.rng_state),
                                      np.asarray(app.renderer.state.rng_state))


class TestImageIO:
    def test_png_valid(self, tmp_path):
        img = np.random.rand(16, 32, 3).astype(np.float32)
        path = write_png(tmp_path / "t.png", img)
        data = path.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        # decode and compare
        import struct
        w, h = struct.unpack(">II", data[16:24])
        assert (w, h) == (32, 16)

    def test_tonemap_clips(self):
        x = np.array([[[-1.0, 0.5, 2.0]]], np.float32)
        u = tonemap_to_u8(x)
        assert u.tolist() == [[[0, 128, 255]]]


class TestObjCli:
    def test_render_obj_via_cli(self, tmp_path):
        """--obj drives the triangle renderer with a loaded mesh (also
        covers clustering of meshes smaller than the cluster count)."""
        obj = tmp_path / "quad.obj"
        obj.write_text(
            "v -200 -50 -300\nv 200 -50 -300\nv 200 50 -300\n"
            "v -200 50 -300\nvn 0 0 1\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n")
        cfgp = tmp_path / "cfg.json"
        cfgp.write_text('{"width": 128, "height": 64, "tiles_per_step": 2}')
        import contextlib
        import os
        from l2n.app.application import main
        out = tmp_path / "frames"
        cwd = os.getcwd()
        os.chdir(tmp_path)  # camera cache lands here
        try:
            rc = main(["--frames", "3", "--out", str(out), "--every", "2",
                       "--obj", str(obj), "--config", str(cfgp)])
        finally:
            os.chdir(cwd)
        assert rc == 0
        assert (out / "frame_00000.png").exists()
        assert (out / "frame_00002.png").exists()
