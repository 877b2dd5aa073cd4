"""chip_smoke.py's phases at tiny sizes on CPU (the kernel interpreted).

On a GPU the script runs them at the headline size; here they check the
phase logic and that the script refuses to report without a GPU."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TINY = dict(width=256, height=64, tile_height=32, tile_width=128,
            sphere_count=32, tiles_per_step=2, spp_per_step=1)


def test_device_phase_fails_without_gpu():
    with pytest.raises(chip_smoke.PhaseFailure, match="not a GPU"):
        chip_smoke.phase_device()


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_exits_nonzero_and_prints_no_result_on_cpu(capsys, argv):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert not [line for line in out.splitlines() if line.startswith("{")]


def test_expected_counts_follow_the_schedule():
    from l2n.config import RenderConfig
    cfg = RenderConfig(**TINY).validate()
    counts = chip_smoke.expected_counts(cfg, steps=3)
    assert counts.shape == (cfg.padded_height, cfg.padded_width)
    # 4 tiles, 2 per step: after 3 steps two tiles have 2 samples, two 1.
    assert sorted(set(counts.ravel().tolist())) == [1.0, 2.0]
    assert counts.sum() == 3 * 2 * 32 * 128


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_main_path_phase(capsys, backend):
    r = chip_smoke.phase_main_path(TINY, frames=2, interpret=True,
                                   backend=backend)
    assert r["backend"] == ("xla" if backend == "auto" else "pallas")
    assert r["ms_per_step"] > 0 and r["lit"] > 0.05
    assert "phase 2 main path" in capsys.readouterr().out


def test_kernel_vs_reference_phase():
    r = chip_smoke.phase_kernel_vs_reference(TINY, interpret=True)
    assert set(r) == {"threefry", "threefry-fast", "tinymt"}
    assert r["tinymt"]["rng_match"] is True
    assert all(v["rmse"] < chip_smoke.RMSE_GATE for v in r.values())


def test_triangle_phase():
    r = chip_smoke.phase_triangle({**TINY, "sphere_count": 16}, frames=1,
                                  interpret=True)
    assert r["backend"] == "xla"
    assert r["ms_per_full_frame_sample"] > 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_four_cards_phase(backend):
    """Four of the eight virtual CPU devices stand in for the cards."""
    cfg = dict(TINY, height=128, sphere_count=16, tiles_per_step=16)
    r = chip_smoke.phase_four_cards(cfg, interpret=True, backend=backend)
    assert r["bit_exact"]
    assert r["mesh"] == (2, 2)
    assert r["rmse"] < chip_smoke.RMSE_GATE


def test_last_line_contract(monkeypatch, capsys):
    """With every phase stubbed to pass, the last line is the JSON object
    the contract names, with the device as JAX reports it."""
    import jax
    dev = jax.devices()[0]
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: [dev])
    for name in ("phase_main_path", "phase_kernel_vs_reference",
                 "phase_triangle"):
        monkeypatch.setattr(chip_smoke, name, lambda **kw: {})
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 1}}
