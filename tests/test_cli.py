"""CLI smoke tests: render/accumulate/bench through the argparse front-end."""

import json
import os

import numpy as np

from bevyray_tpu.app.cli import main


def test_cli_render(tmp_path, capsys):
    out = str(tmp_path / "x.png")
    rc = main(["render", "--scene", "material", "--width", "32", "--height", "24",
               "--spp", "1", "--bounces", "2", "--out", out])
    assert rc == 0
    assert os.path.getsize(out) > 100
    assert "Mrays/s" in capsys.readouterr().out


def test_cli_accumulate(tmp_path, capsys):
    out = str(tmp_path / "acc.png")
    rc = main(["accumulate", "--scene", "simple", "--width", "16", "--height", "16",
               "--spp", "1", "--bounces", "2", "--passes", "2", "--out", out])
    assert rc == 0
    assert "accumulated 2 spp" in capsys.readouterr().out


def test_cli_bench_json(capsys):
    rc = main(["bench", "--scene", "simple", "--width", "16", "--height", "16",
               "--spp", "1", "--bounces", "1", "--frames", "2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert {"metric", "value", "unit", "p50_frame_ms", "rays_per_frame"} <= set(rec)
    assert rec["value"] > 0
    # Methodology parity with bench.py: the throughput numerator is the mean
    # ray count of the TIMED frames (seeds 1..N), never the warmup frame's.
    np.testing.assert_allclose(
        rec["value"], rec["rays_per_frame"] / rec["p50_frame_ms"] / 1e3,
        rtol=0.02, atol=0.006)   # value/p50 are rounded to 2 decimals


def test_cli_bench_rays_come_from_timed_frames(capsys, monkeypatch):
    # Per-seed path lengths differ; the JSON's rays_per_frame must be the mean
    # over the timed seeds (1..frames), not the warmup seed 0 count.
    from bevyray_tpu.engine import renderer as renderer_mod

    seen = {}
    real_render = renderer_mod.Renderer.render

    def spy(self, scene, cam, seed=0, **kw):
        frame = real_render(self, scene, cam, seed=seed, **kw)
        seen[seed] = float(frame.rays_traced)
        return frame

    monkeypatch.setattr(renderer_mod.Renderer, "render", spy)
    rc = main(["bench", "--scene", "material", "--width", "32", "--height",
               "32", "--spp", "2", "--bounces", "4", "--frames", "3",
               "--backend", "brute"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    timed = [seen[s] for s in (1, 2, 3)]
    assert rec["rays_per_frame"] == int(np.mean(timed))


def test_cli_platform_flag(tmp_path, capsys):
    # --platform is applied before backend init. Under the suite the platform
    # is already cpu, so this checks the flag parses, the update is a no-op
    # re-set, and the render completes.
    out = str(tmp_path / "p.png")
    rc = main(["render", "--scene", "simple", "--width", "16", "--height",
               "16", "--spp", "1", "--bounces", "1", "--platform", "cpu",
               "--out", out])
    assert rc == 0
    assert os.path.getsize(out) > 100
    assert "Mrays/s" in capsys.readouterr().out
