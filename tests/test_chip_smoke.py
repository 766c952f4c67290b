"""``chip_smoke.py`` and ``bench.py`` off the card: without a GPU they exit
non-zero and print no contract line; each phase of the smoke run rehearses at a
tiny size on the CPU (the on-card run uses the same functions at full width)."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_no_ok_line(script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "GPU" in proc.stderr


def test_contract_line_has_exactly_the_three_device_keys():
    rec = json.loads(chip_smoke.contract_line(jax.devices()[:1]))
    assert rec == {"ok": True, "device": {"platform": "cpu",
                                          "kind": jax.devices()[0].device_kind,
                                          "count": 1}}


def test_rehearse_headline_and_determinism(capsys):
    state = chip_smoke.phase_headline(32, 24, 2, 2, 3, frames=2)
    chip_smoke.phase_determinism(*state)
    out = capsys.readouterr().out
    assert "smoke frame seed=2" in out and "bit-identical" in out


def test_rehearse_cli(tmp_path, capsys):
    chip_smoke.phase_cli(32, 24, passes=2, out_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert out.count("intersect backend: brute") == 3
    assert "adaptive:" in out


def test_rehearse_dense_bvh(capsys):
    chip_smoke.phase_dense(4200, 32, 24, 1)
    assert "intersect bvh" in capsys.readouterr().out


def test_rehearse_parity(capsys):
    from bevyray_tpu.testing.parity import GOLDEN_CASES

    chip_smoke.phase_parity(32, 24, cases=[GOLDEN_CASES["simple-L2"]])
    out = capsys.readouterr().out
    assert "simple-L2 bvh vs oracle" in out and "card vs host CPU" in out


def test_rehearse_four_cards(capsys):
    chip_smoke.phase_four_cards(32, 24, 4, 2)
    out = capsys.readouterr().out
    for shape in chip_smoke.FOUR_CARD_MESHES:
        assert f"mesh (sp, dp, tp)={shape}" in out
