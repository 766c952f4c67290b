"""Moving-camera (orbit) and per-frame-edit benches on one GPU.

The reference is an interactive app: a flycam mutates the camera every frame
(main.rs:34-45) and edits re-extract the scene (extract.rs:280-337). This script
measures that loop two ways per mutation kind:

- ``synced``     — mutate, render, block on the frame: the latency a caller
                   sees if it insists on the frame before continuing.
- ``pipelined``  — dispatch frame i, then do frame i+1's host work (camera
                   state, or edit + extract) while the device renders, THEN
                   block on frame i: per-frame cost becomes
                   max(device, host) instead of device + host.

Static-camera p50 is measured in the same session as the reference point.

    python scripts/bench_orbit.py      # one JSON line per row
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def orbit_cams(world, frames, aspect, arc_deg=40.0):
    """Camera states along a horizontal arc about the look-at target (the
    gentle flycam analog; full 360° would point the camera out of the scene
    half the time)."""
    from bevyray_tpu import Transform

    base = np.asarray(world.camera_transform.translation, np.float64)
    target = base + np.asarray(world.camera_transform.forward, np.float64)
    rel = base - target
    radius = np.hypot(rel[0], rel[2])
    th0 = np.arctan2(rel[2], rel[0])
    cams = []
    for i in range(frames):
        th = th0 + np.deg2rad(arc_deg) * (i / max(frames - 1, 1) - 0.5)
        pos = target + np.array([radius * np.cos(th), rel[1],
                                 radius * np.sin(th)])
        world.set_camera(Transform.from_xyz(*pos).looking_at(tuple(target)))
        cams.append(world.camera_state(aspect=aspect))
    return cams


def p50_ms(ts):
    return float(np.percentile(ts, 50)) * 1e3


def bench(width=1920, height=1080, spp=16, bounces=4, frames=24, seed=42):
    from bevyray_tpu import RenderConfig, Renderer, rtiow

    world = rtiow.final_scene(seed=seed)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    renderer = Renderer(config)
    scene = world.extract(with_bvh=False)
    cams = orbit_cams(world, frames, width / height)
    static_cam = cams[frames // 2]
    jax.block_until_ready(renderer.render(scene, static_cam, seed=0))
    rows = []

    def record(name, ts, **kw):
        row = {"config": f"{name} {width}x{height}/{spp}spp",
               "p50_ms": p50_ms(ts), **kw}
        if rows:
            row["overhead_pct"] = 100 * (row["p50_ms"] / rows[0]["p50_ms"] - 1)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def loop(frame_cam, next_work=None, pipelined=False):
        """Per-frame times; ``next_work(i)`` is frame i's host work."""
        ts, work = [], None
        for i in range(frames):
            t0 = time.perf_counter()
            if not pipelined and next_work is not None:
                work = next_work(i)
            fr = renderer.render(work if work is not None else scene,
                                 frame_cam(i), seed=i + 1)
            if pipelined and next_work is not None:
                work = next_work(i)     # overlaps this frame's device work
            jax.block_until_ready(fr)
            ts.append(time.perf_counter() - t0)
        return ts

    record("static", loop(lambda i: static_cam))
    record("orbit-synced", loop(lambda i: cams[i]))

    rng = np.random.default_rng(7)

    def apply_edit(i):
        eid = int(rng.integers(0, world.n_spheres))
        world.set_translation(eid, (float(rng.uniform(-8, 8)), 0.2,
                                    float(rng.uniform(-8, 8))))
        return world.extract(with_bvh=False)

    record("edit-synced", loop(lambda i: static_cam, apply_edit))
    record("edit-pipelined", loop(lambda i: static_cam, apply_edit,
                                  pipelined=True))
    return rows


def main():
    from bevyray_tpu.utils.compile_cache import enable_compile_cache
    from bevyray_tpu.utils.device import card_lines, device_record, require_gpus

    devices = require_gpus(1)
    enable_compile_cache()
    print("\n".join(card_lines()), flush=True)
    rows = bench()
    rows += bench(width=1280, height=720, spp=4, frames=24)
    print(json.dumps({"device": device_record(devices), "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
