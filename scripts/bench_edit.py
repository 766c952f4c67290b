"""Interactive edit-loop benchmark on one GPU — the reference's acknowledged
weakness, measured.

The reference re-extracts the scene and rebuilds/re-uploads every buffer every
frame whether anything changed or not (extract.rs:280-337, acknowledged at
README.md:17). This rebuild dirty-tracks instead: an unchanged scene costs zero
host work per frame, but an EDIT pays the full pipeline — World mutation →
revision-keyed re-extract and upload → frame. This script drives that loop at
cadence (the analog of dragging a gizmo in the reference's live window) and
reports, per stage and end-to-end:

- ``steady_ms``  — unchanged-scene frame (every cache hits)
- ``edit_ms``    — full edit→frame latency
- stage breakdown: extract (host tables + upload) / render

    python scripts/bench_edit.py       # one JSON line per config
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_edit_loop(width=1920, height=1080, spp=16, bounces=4, frames=12):
    from bevyray_tpu import RenderConfig, Renderer, rtiow

    world = rtiow.final_scene(seed=42)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    renderer = Renderer(config)
    cam = world.camera_state(aspect=width / height)
    jax.block_until_ready(renderer.render(world.extract(with_bvh=False), cam,
                                          seed=0))

    steady = []
    for i in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render(world.extract(with_bvh=False),
                                              cam, seed=i + 1))
        steady.append(time.perf_counter() - t0)

    # Move one sphere every frame; time each stage, then edit→frame.
    stage = {"extract": [], "render": []}
    edit = []
    rng = np.random.default_rng(7)
    for i in range(frames):
        eid = int(rng.integers(0, world.n_spheres))
        t_all = time.perf_counter()
        world.set_translation(eid, (float(rng.uniform(-8, 8)), 0.2,
                                    float(rng.uniform(-8, 8))))
        scene = jax.block_until_ready(world.extract(with_bvh=False))
        stage["extract"].append(time.perf_counter() - t_all)
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render(scene, cam, seed=100 + i))
        stage["render"].append(time.perf_counter() - t0)
        edit.append(time.perf_counter() - t_all)

    def p50(xs):
        return float(np.percentile(xs, 50)) * 1e3

    row = {
        "config": f"edit-loop final scene {width}x{height}/{spp}spp",
        "steady_ms": p50(steady),
        "edit_ms": p50(edit),
        "stage_ms": {k: p50(v) for k, v in stage.items()},
        "n_spheres": world.n_spheres,
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    from bevyray_tpu.utils.compile_cache import enable_compile_cache
    from bevyray_tpu.utils.device import card_lines, device_record, require_gpus

    devices = require_gpus(1)
    enable_compile_cache()
    print("\n".join(card_lines()), flush=True)
    rows = [bench_edit_loop(),
            bench_edit_loop(width=1280, height=720, spp=4, frames=12)]
    print(json.dumps({"device": device_record(devices), "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
