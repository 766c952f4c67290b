"""The measurement scripts rehearsed at a tiny size on the CPU: each runs the
XLA path end to end and returns well-formed rows (their on-card ``main()``
refuses to run without a GPU, see tests/test_chip_smoke.py)."""

import os
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def test_bench_measure():
    import bench

    rec = bench.measure(width=32, height=18, spp=1, bounces=2, frames=2)
    assert rec["value"] > 0 and rec["rays_per_frame"] > 0
    assert rec["n_spheres"] == 508


def test_bench_matrix_rows():
    import bench_matrix

    rows = bench_matrix.rows(scale=0.03, frames=1, accum_passes=2)
    assert len(rows) == 5
    assert all(r["segments_per_s"] > 0 for r in rows)


def test_bench_orbit_rows():
    import bench_orbit

    rows = bench_orbit.bench(width=24, height=16, spp=1, bounces=2, frames=3)
    assert [r["config"].split()[0] for r in rows] == [
        "static", "orbit-synced", "edit-synced", "edit-pipelined"]


def test_bench_edit_loop():
    import bench_edit

    row = bench_edit.bench_edit_loop(width=24, height=16, spp=1, bounces=2,
                                     frames=2)
    assert set(row["stage_ms"]) == {"extract", "render"}


def test_scaling_bench_on_four_devices():
    import scaling_bench

    assert scaling_bench.run(n_max=4, width=16, height=16, spp=2)


def test_graft_entry_dryrun_and_entry(capsys):
    import __graft_entry__ as g

    g.dryrun_multichip(4)
    assert "dryrun_multichip ok" in capsys.readouterr().out
    fn, args = g.entry()
    img = np.asarray(jax.jit(fn)(*args))
    assert img.shape == (256, 256, 3) and np.isfinite(img).all()
