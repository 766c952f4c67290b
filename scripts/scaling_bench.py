"""Multi-device structure check for the sharded XLA frame step
(``parallel/sharding.py``) on a virtual CPU mesh of 1/2/4/8 devices.

It validates the SCALING STRUCTURE, not wall-clock: that the sharded program
compiles and executes at every mesh shape, that every mesh produces the same
image and the same traced-segment count as the 1-device run (so scaling changes
nothing but placement). Timing across cards is ``chip_smoke.py --four-cards``.

    python scripts/scaling_bench.py [--out FILE]

When this process already holds a backend with the wrong device set, it re-runs
itself in a child with ``JAX_PLATFORMS=cpu``, so the child never reserves memory
on a card the parent holds.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RECORDS: list = []


def _emit(rec):
    _RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def _provision(n):
    import jax
    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n)
    except Exception:
        pass   # backend already initialized; the device check decides
    devs = jax.devices()
    return len(devs) >= n and devs[0].platform == "cpu"


def run(n_max: int = 8, width=64, height=64, spp=8):
    """Render on each mesh shape; returns True when all match 1 device."""
    import jax

    sys.path.insert(0, ROOT)
    from bevyray_tpu import RenderConfig, rtiow
    from bevyray_tpu.parallel.sharding import (default_mesh_shape, make_mesh,
                                               render_frame_sharded)

    world = rtiow.final_scene(seed=42, grid=3)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=width / height)
    config = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                          bounces=4, level=3)
    ok, ref_img, ref_rays = True, None, None
    for n in (1, 2, 4, 8):
        if n > n_max:
            break
        sp, dp, tp = default_mesh_shape(n)
        frame = render_frame_sharded(make_mesh(sp, dp, tp), scene, cam, config,
                                     frame_seed=7)
        img = np.asarray(jax.block_until_ready(frame.image))
        rays = float(frame.rays_traced)
        if ref_img is None:
            ref_img, ref_rays = img, rays
        # dp splits each pixel's sample sum over devices (another summation
        # order); the segment count is an integer-valued f32 sum, exact here.
        same = bool(np.abs(img - ref_img).max() < 2e-6) and rays == ref_rays
        ok &= same
        _emit({"devices": n, "mesh": {"sp": sp, "dp": dp, "tp": tp},
               "rays": int(rays), "matches_1dev": same})
    _emit({"scaling_ok": ok, "note": "virtual CPU mesh — validates "
           "compile/execute/equality per mesh shape, not wall-clock"})
    return ok


def main(n_max: int = 8, out_path=None):
    if not _provision(n_max):
        if os.environ.get("_BEVYRAY_SCALING_CHILD"):   # one re-exec level only
            print("cannot provision a CPU mesh even in a clean subprocess",
                  file=sys.stderr)
            return 1
        proc = subprocess.run([sys.executable, __file__, *sys.argv[1:]],
                              cwd=ROOT,
                              env={**os.environ, "JAX_PLATFORMS": "cpu",
                                   "_BEVYRAY_SCALING_CHILD": "1"},
                              capture_output=True, text=True, timeout=2400)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-1000:] if proc.returncode else "")
        return proc.returncode
    ok = run(n_max)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"probe_script": "scripts/scaling_bench.py",
                       "records": _RECORDS}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    out = None
    if "--out" in sys.argv:
        out = sys.argv[sys.argv.index("--out") + 1]
    sys.exit(main(out_path=out))
