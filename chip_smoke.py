"""On-card smoke run: the renderer's main path, end to end, on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded step only

One process drives the card(s), and the run stops at the first failure with a
non-zero exit. Phases (one card):

- headline: ``rtiow.final_scene(seed=42)`` at 1920x1080, 16 spp, 4 bounces,
  level 3 through ``Renderer`` — compile time, three smoke frames, rays traced,
  ``memory_analysis`` and peak device memory;
- cli: the reference app's settings (1080p, 4 spp x 4 bounces, level 2 with the
  raster layer) through ``cli.main(["render", ...])``, then four passes of
  ``cli.main(["accumulate", ...])`` plain and with ``--adaptive-tolerance``;
- dense: the 5,000-sphere dense scene at 640x384, 4 spp, where ``auto`` walks
  the BVH, checked against the brute-force path;
- parity: the golden scenes against the NumPy oracle, and the headline config
  at 1 spp on the card against the host's CPU device;
- determinism: the same headline seed twice, compared bit for bit.

The timings are smoke timings, not a benchmark. The last line of standard output
is the contract line ``{"ok": true, "device": {...}}``; nothing prints it unless
every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import time

# The parity phase renders a reference frame on the host's CPU device in this
# same process, so the CPU platform must be initialised beside the GPU.
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_out")
HEADLINE = dict(width=1920, height=1080, spp=16, bounces=4, level=3)
FOUR_CARD_MESHES = ((4, 1, 1), (2, 2, 1), (1, 4, 1), (1, 2, 2))
# Final-scene tolerances (glass and metal): tests/test_golden.py's limits.
FINAL_TOL = dict(mean_tol=4e-3, max_outlier_frac=0.02)
# rays_traced is an f32 sum; past 2**24 segments its last bits depend on the
# order of the partial sums (per shard, then psum).
RAYS_RTOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def contract_line(devices) -> str:
    """The last line of a passing run."""
    from bevyray_tpu.utils.device import device_record

    return json.dumps({"ok": True, "device": device_record(devices)})


def _timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _check_frame(frame, width, height):
    img = np.asarray(frame.image)
    assert img.shape == (height, width, 3), img.shape
    assert np.isfinite(img).all(), "non-finite pixels"
    assert float(frame.rays_traced) > 0, "no ray traced"
    return img


def _render_args(world, config, seed):
    from bevyray_tpu.core.vec import Vec3

    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=config.width / config.height)
    return dict(scene=scene, cam=cam, frame_seed=np.uint32(seed),
                raster_color=Vec3.splat(np.float32(1.0)),
                raster_depth=np.float32(0.0))


def _headline_config(width, height, spp, bounces, level):
    from bevyray_tpu import RenderConfig

    return RenderConfig(width=width, height=height, samples_per_pixel=spp,
                        bounces=bounces, level=level)


def phase_headline(width, height, spp, bounces, level, frames=3):
    """Headline frame through ``Renderer``; returns (renderer, scene, cam,
    {seed: image}) for the determinism phase."""
    from bevyray_tpu import Renderer, rtiow
    from bevyray_tpu.engine.renderer import resolve_intersect_backend

    p = "headline"
    world = rtiow.final_scene(seed=42)
    config = _headline_config(width, height, spp, bounces, level)
    renderer = Renderer(config)
    args = _render_args(world, config, seed=0)
    log(p, f"{world.n_spheres} spheres, {width}x{height}, {spp} spp, "
           f"{bounces} bounces, level {level}, intersect "
           f"{resolve_intersect_backend(args['scene'], config)}")
    t0 = time.perf_counter()
    compiled = renderer._fn.lower(**args).compile()
    log(p, f"set-up: compile {time.perf_counter() - t0:.3f} s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log(p, "memory_analysis: " + ", ".join(
            f"{k}={getattr(mem, k)}" for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")))
    scene, cam = args["scene"], args["cam"]
    _, dt = _timed(lambda: renderer.render(scene, cam, seed=0))
    log(p, f"set-up: first call {dt:.3f} s")
    images = {}
    for seed in range(1, frames + 1):
        frame, dt = _timed(lambda: renderer.render(scene, cam, seed=seed))
        images[seed] = _check_frame(frame, width, height)
        rays = float(frame.rays_traced)
        log(p, f"smoke frame seed={seed}: {dt * 1e3:.3f} ms, rays_traced "
               f"{rays:.0f} ({rays / dt / 1e6:.1f} M segments/s, smoke timing, "
               "not a benchmark)")
    stats = jax.devices()[0].memory_stats() or {}
    peak, limit = stats.get("peak_bytes_in_use"), stats.get("bytes_limit")
    pair_block = width * height * config.sphere_chunk * 4
    log(p, f"peak_bytes_in_use {peak} of bytes_limit {limit}; one "
           f"[rays x sphere_chunk] f32 pair block is {pair_block} bytes")
    return renderer, scene, cam, images


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG"
    return struct.unpack(">II", head[16:24])


def phase_cli(width, height, passes, out_dir=OUT_DIR):
    """The reference app's settings through the CLI, in this process."""
    from bevyray_tpu.app.cli import main as cli_main

    os.makedirs(out_dir, exist_ok=True)
    common = ["--scene", "final", "--width", str(width), "--height",
              str(height), "--spp", "4", "--bounces", "4", "--level", "2"]
    runs = [("render", ["render"], "hybrid.png"),
            ("accumulate", ["accumulate", "--passes", str(passes)],
             "accumulate.png"),
            ("adaptive", ["accumulate", "--passes", str(passes),
                          "--adaptive-tolerance", "0.05"], "adaptive.png")]
    for name, cmd, png in runs:
        out = os.path.join(out_dir, png)
        t0 = time.perf_counter()
        rc = cli_main(cmd + common + ["--out", out])
        dt = time.perf_counter() - t0
        assert rc == 0, f"cli {name} returned {rc}"
        assert _png_size(out) == (width, height), _png_size(out)
        log("cli", f"{name}: {dt:.3f} s including compile -> {out}")


def phase_dense(n, width, height, spp):
    """Dense scene through ``Renderer`` with ``auto`` (the BVH walk), held to
    the brute-force path at the same seed."""
    import dataclasses

    from bevyray_tpu import RenderConfig, Renderer, rtiow
    from bevyray_tpu.bvh import native
    from bevyray_tpu.engine.renderer import resolve_intersect_backend
    from bevyray_tpu.testing.parity import assert_images_match

    p = "dense"
    world = rtiow.dense_scene(n=n)
    t0 = time.perf_counter()
    scene = world.extract(with_bvh=True)
    jax.block_until_ready(scene)
    builder = ("native C++ (bvh/csrc/libploc.so)" if native.ensure_built()
               else "NumPy fallback")
    log(p, f"{world.n_spheres} spheres: extract + BVH build "
           f"{time.perf_counter() - t0:.3f} s, builder {builder}")
    cam = world.camera_state(aspect=width / height)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=4, level=3)
    backend = resolve_intersect_backend(scene, config)
    log(p, f"{width}x{height}, {spp} spp: intersect {backend}")
    images = {}
    for name, cfg in (("auto", config), ("brute", dataclasses.replace(
            config, intersect_backend="brute"))):
        r = Renderer(cfg)
        _, dt = _timed(lambda: r.render(scene, cam, seed=1))
        frame, dt2 = _timed(lambda: r.render(scene, cam, seed=2))
        images[name] = _check_frame(frame, width, height)
        log(p, f"{name}: first call {dt:.3f} s, smoke frame {dt2 * 1e3:.3f} ms,"
               f" rays_traced {float(frame.rays_traced):.0f}")
    m = assert_images_match(images["auto"], images["brute"], **FINAL_TOL)
    log(p, f"{backend} vs brute: mean |err| {m['mean_err']:.3e} (limit "
           f"{FINAL_TOL['mean_tol']}), outliers {m['outlier_frac']:.4f} "
           f"(limit {FINAL_TOL['max_outlier_frac']})")


def phase_parity(width, height, cases=None, backends=("brute", "bvh")):
    """Golden scenes vs the oracle on the card, then the headline config at
    1 spp on the card vs the host's CPU device."""
    from bevyray_tpu import rtiow
    from bevyray_tpu.testing.parity import (GOLDEN_CASES, assert_images_match,
                                            render_world, run_case)

    p = "parity"
    for case in (GOLDEN_CASES.values() if cases is None else cases):
        for backend in backends:
            m = run_case(case, intersect_backend=backend)
            log(p, f"{case.name} {backend} vs oracle: mean |err| "
                   f"{m['mean_err']:.3e} (limit {m['mean_tol']}), outliers "
                   f"{m['outlier_frac']:.4f} (limit {m['max_outlier_frac']})")
    config = _headline_config(width, height, 1, HEADLINE["bounces"],
                              HEADLINE["level"])
    card, _ = render_world(rtiow.final_scene(seed=42), config, seed=5)
    with jax.default_device(jax.devices("cpu")[0]):
        host, _ = render_world(rtiow.final_scene(seed=42), config, seed=5)
    m = assert_images_match(card, host, **FINAL_TOL)
    within = float((np.abs(card - host).max(axis=-1) <= 1e-3).mean())
    log(p, f"{width}x{height} 1 spp card vs host CPU: {within:.4f} of pixels "
           f"within 1e-3, mean |err| {m['mean_err']:.3e} (limit "
           f"{FINAL_TOL['mean_tol']}), outliers {m['outlier_frac']:.4f} "
           f"(limit {FINAL_TOL['max_outlier_frac']})")


def phase_determinism(renderer, scene, cam, images, seed=1):
    """Re-render a headline seed and compare bit for bit."""
    frame = jax.block_until_ready(renderer.render(scene, cam, seed=seed))
    again, first = np.asarray(frame.image), images[seed]
    diff = np.abs(again - first)
    if np.array_equal(again, first):
        log("determinism", f"seed {seed} twice: bit-identical")
    else:
        # No cross-pixel reduction feeds a pixel (the sphere min is
        # order-free), so a difference would point at XLA's autotuned
        # kernels choosing differently between the two calls.
        log("determinism", f"seed {seed} twice: NOT bit-identical, "
                           f"{(diff > 0).mean():.6f} of values differ, "
                           f"max |diff| {diff.max():.3e}")


def phase_four_cards(width, height, spp, bounces, level=3,
                     meshes=FOUR_CARD_MESHES):
    """The sharded step on each mesh vs single-card ``Renderer`` on device 0."""
    from bevyray_tpu import Renderer, rtiow
    from bevyray_tpu.parallel.sharding import make_mesh, render_frame_sharded
    from bevyray_tpu.testing.parity import assert_images_match

    p = "four-cards"
    world = rtiow.final_scene(seed=42)
    config = _headline_config(width, height, spp, bounces, level)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=width / height)
    r = Renderer(config)
    _, dt = _timed(lambda: r.render(scene, cam, seed=7))
    want, dt2 = _timed(lambda: r.render(scene, cam, seed=7))
    want_img = _check_frame(want, width, height)
    want_rays = float(want.rays_traced)
    log(p, f"single card (device 0): first call {dt:.3f} s, smoke frame "
           f"{dt2 * 1e3:.3f} ms, rays_traced {want_rays:.0f}")
    for shape in meshes:
        mesh = make_mesh(*shape)
        _, dt = _timed(lambda: render_frame_sharded(mesh, scene, cam, config, 7))
        got, dt2 = _timed(
            lambda: render_frame_sharded(mesh, scene, cam, config, 7))
        img = _check_frame(got, width, height)
        m = assert_images_match(img, want_img, **FINAL_TOL)
        rays = float(got.rays_traced)
        assert abs(rays - want_rays) <= RAYS_RTOL * want_rays, (rays, want_rays)
        assert len(got.image.sharding.device_set) == len(mesh.devices.flat), (
            f"the frame lives on {got.image.sharding.device_set} only")
        log(p, f"mesh (sp, dp, tp)={shape}: first call {dt:.3f} s, smoke "
               f"frame {dt2 * 1e3:.3f} ms, mean |err| {m['mean_err']:.3e} "
               f"(limit {FINAL_TOL['mean_tol']}), outliers "
               f"{m['outlier_frac']:.4f}, rays_traced {rays:.0f}")
    stats = [d.memory_stats() for d in mesh.devices.flat]
    if all(stats):   # the CPU platform keeps no memory stats
        peaks = [st.get("peak_bytes_in_use", 0) for st in stats]
        log(p, f"peak_bytes_in_use per device: {peaks}")
        assert min(peaks) > 0, "a device of the mesh held nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded step on four cards")
    args = ap.parse_args(argv)

    from bevyray_tpu.utils.device import card_lines, require_gpus

    devices = require_gpus(4 if args.four_cards else 1)
    from bevyray_tpu.utils.compile_cache import enable_compile_cache

    log("device", f"{devices[0].device_kind} x{len(devices)}, compile cache "
                  f"{enable_compile_cache()}")
    for line in card_lines():
        print(line, flush=True)

    h = HEADLINE
    phases = []
    if args.four_cards:
        phases.append(("four-cards", lambda: phase_four_cards(
            h["width"], h["height"], h["spp"], h["bounces"], h["level"])))
    else:
        state = {}
        phases += [
            ("headline", lambda: state.update(hl=phase_headline(**h))),
            ("cli", lambda: phase_cli(h["width"], h["height"], passes=4)),
            ("dense", lambda: phase_dense(5000, 640, 384, 4)),
            ("parity", lambda: phase_parity(h["width"], h["height"])),
            ("determinism", lambda: phase_determinism(*state["hl"])),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException:
            print(f"[{name}] FAILED", flush=True)
            raise
        log(name, f"passed in {time.perf_counter() - t0:.1f} s")
    print(contract_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
