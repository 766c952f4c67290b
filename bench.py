"""Headline frame timing: RTiOW final scene, 1080p, 16 spp, 4 bounces, on one GPU.

    python bench.py

Renders through ``Renderer`` (the XLA wavefront), ending every timed frame with
``jax.block_until_ready``, and varies the seed per frame. Prints the card's name and
power limit, then ONE JSON line: traced segments per second (``rays_traced``,
counted on device, over the median frame time), p50 frame ms, compile time and the
device as JAX reports it. Exits non-zero without a GPU; it never times the CPU.
"""

import json
import sys
import time

import jax
import numpy as np


def measure(width=1920, height=1080, spp=16, bounces=4, frames=12) -> dict:
    """Time the headline frame on the default device; returns the record."""
    from bevyray_tpu import RenderConfig, Renderer, rtiow

    world = rtiow.final_scene(seed=42)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=bounces, level=3)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=width / height)
    renderer = Renderer(config)

    t0 = time.perf_counter()
    jax.block_until_ready(renderer.render(scene, cam, seed=0))
    first_call = time.perf_counter() - t0

    times, rays = [], []   # the numerator comes from the TIMED frames
    for i in range(frames):
        t0 = time.perf_counter()
        frame = jax.block_until_ready(renderer.render(scene, cam, seed=i + 1))
        times.append(time.perf_counter() - t0)
        rays.append(float(frame.rays_traced))

    p50 = float(np.percentile(times, 50))
    rays_per_frame = float(np.mean(rays))
    return {
        "metric": f"traced segments/s (RTiOW final scene, {width}x{height}, "
                  f"{spp}spp, {bounces} bounces)",
        "value": rays_per_frame / p50,
        "unit": "segments/s",
        "p50_frame_ms": p50 * 1e3,
        "first_call_s": first_call,
        "rays_per_frame": rays_per_frame,
        "n_spheres": world.n_spheres,
    }


def main():
    from bevyray_tpu.utils.device import card_lines, device_record, require_gpus

    devices = require_gpus(1)
    from bevyray_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for line in card_lines():
        print(line, flush=True)
    print(json.dumps({**measure(), "device": device_record(devices)}))


if __name__ == "__main__":
    sys.exit(main())
