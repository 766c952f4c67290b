"""Render every BASELINE.json config at full size on one GPU and report
throughput — the per-config evidence behind the single-number bench.py.

    python scripts/bench_matrix.py        # one JSON line per config + summary

Configs (BASELINE.json):
 1. RTiOW ch.9: 3 Lambertian spheres + ground, 256x256, 4 spp, depth 8
 2. Metal + dielectric materials, 512x512, 16 spp
 3. RTiOW final scene (~500 spheres), 720p, 16 spp
 4. Defocus + emissive + cosine sampling, 1080p, 64 spp accumulation
 5. Hybrid: raster layer (cube) depth-blended + triangle mesh, 720p, 16 spp

Every timed frame ends in ``jax.block_until_ready``; ``rows(scale=...)`` runs the
same configs at a fraction of their size (the CPU rehearsal in the tests).
"""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(render, n=3):
    jax.block_until_ready(render(0))
    ts, rays = [], []
    for i in range(n):
        t0 = time.perf_counter()
        f = jax.block_until_ready(render(i + 1))
        ts.append(time.perf_counter() - t0)
        rays.append(float(f.rays_traced))
    return float(np.percentile(ts, 50)), float(np.mean(rays))


def rows(scale=1.0, frames=3, accum_passes=16):
    """One dict per config; sizes are the configs' own times ``scale``."""
    from bevyray_tpu import (RaytracedCamera, Raytracing, RenderConfig,
                             Renderer, StandardMaterial, Transform, rtiow)
    from bevyray_tpu.engine.film import ProgressiveRenderer
    from bevyray_tpu.engine.raster import raster_layer
    from bevyray_tpu.scene.components import cube_mesh

    def px(n):
        return max(8, int(n * scale))

    out = []

    def record(name, world, w, h, spp, bounces, level, **kw):
        cfg = RenderConfig(width=px(w), height=px(h), samples_per_pixel=spp,
                           bounces=bounces, level=level, **kw)
        cam = world.camera_state(aspect=cfg.width / cfg.height)
        rc, rd = (raster_layer(world, cam, cfg) if level < 3
                  else (None, None))
        r = Renderer(cfg)
        sc = world.extract(with_bvh=False)
        p50, rays = _time(lambda s: r.render(sc, cam, seed=s, raster_color=rc,
                                             raster_depth=rd), frames)
        row = {"config": f"{name} {cfg.width}x{cfg.height}/{spp}spp",
               "p50_ms": p50 * 1e3, "segments_per_s": rays / p50}
        out.append(row)
        print(json.dumps(row), flush=True)

    record("1: ch9", rtiow.simple_scene(), 256, 256, 4, 8, 3)
    record("2: materials", rtiow.material_test_scene(), 512, 512, 16, 8, 3)
    record("3: final", rtiow.final_scene(seed=42), 1280, 720, 16, 4, 3)

    # 4. defocus + emissive + cosine, 1080p, 64 spp via accumulation (16x4)
    w = rtiow.night_scene(camera=RaytracedCamera(
        level=Raytracing.PURE, aperture=0.15, focus_distance=6.0))
    cfg = RenderConfig(width=px(1920), height=px(1080), samples_per_pixel=4,
                       bounces=4, level=3, defocus=True,
                       diffuse_sampling="cosine")
    prog = ProgressiveRenderer(cfg)
    sc, cam = w.extract(with_bvh=False), w.camera_state(aspect=16 / 9)
    f = jax.block_until_ready(prog.step(sc, cam, seed=0))   # compile
    t0 = time.perf_counter()
    rays0 = float(f.rays_traced)
    for i in range(accum_passes - 1):
        f = prog.step(sc, cam, seed=i + 1)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    out.append({"config": f"4: defocus+emissive+cosine {cfg.width}x"
                          f"{cfg.height}/{prog.samples_accumulated}spp accum",
                "total_s": dt,
                "segments_per_s": (float(f.rays_traced) - rays0) / dt})
    print(json.dumps(out[-1]), flush=True)

    # 5. hybrid 720p/16spp: final scene + raster cube + a triangle mesh
    w = rtiow.final_scene(seed=42)
    w.spawn_mesh(Transform.from_xyz(-4.0, 0.6, 1.0), cube_mesh(1.2),
                 StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                  perceptual_roughness=0.15))
    record("5: hybrid raster+mesh", w, 1280, 720, 16, 4, 2)
    return out


def main():
    from bevyray_tpu.utils.compile_cache import enable_compile_cache
    from bevyray_tpu.utils.device import card_lines, device_record, require_gpus

    devices = require_gpus(1)
    enable_compile_cache()
    print("\n".join(card_lines()), flush=True)
    out = rows()
    print(json.dumps({"device": device_record(devices), "rows": len(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
