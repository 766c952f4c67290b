"""Renderer-vs-oracle comparison, shared by the CPU test suite and ``chip_smoke.py``.

The XLA renderer and the NumPy oracle consume identical RNG draws (the slot
contract), so they compute the same estimate; disagreement is limited to libm and
fma-contraction differences (~1e-5 per op), which can chaotically flip a hit or
branch decision on a small set of rays. Comparisons therefore use robust metrics:
a tight mean error plus a small allowance of outlier pixels. The same limits hold
on every device: the XLA path has no matrix product, so no reduced-precision
(TF32) arithmetic can enter on a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.types import RenderConfig
from .oracle import oracle_inputs_from_world, render_oracle, render_oracle_fast

OUTLIER_TOL = 5e-3   # a pixel is an outlier when any channel is off by more


def image_metrics(got, want, outlier_tol: float = OUTLIER_TOL) -> dict:
    """Mean |err| and the fraction of pixels off by more than ``outlier_tol``."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return {"mean_err": float(err.mean()),
            "outlier_frac": float((err.max(axis=-1) > outlier_tol).mean())}


def assert_images_match(got, want, mean_tol: float = 2e-3,
                        outlier_tol: float = OUTLIER_TOL,
                        max_outlier_frac: float = 0.01) -> dict:
    """Raise AssertionError unless both robust metrics are within their limits;
    returns the metrics."""
    m = image_metrics(got, want, outlier_tol)
    assert m["mean_err"] < mean_tol, f"mean err {m['mean_err']} >= {mean_tol}"
    assert m["outlier_frac"] < max_outlier_frac, (
        f"outlier fraction {m['outlier_frac']} >= {max_outlier_frac}")
    return m


def _raster(world, cam, config):
    """The world's raster layer for hybrid levels, or (None, None)."""
    if config.level >= 3 or world.n_raster == 0:
        return None, None
    from ..engine.raster import raster_layer

    return raster_layer(world, cam, config)


def render_world(world, config: RenderConfig, seed: int):
    """Render ``world`` through ``Renderer`` (raster layer included for the
    hybrid levels); returns ``(image [H,W,3], rt_depth [H,W])`` as NumPy."""
    from ..engine.renderer import Renderer

    with_bvh = config.intersect_backend in ("auto", "bvh")
    scene = world.extract(with_bvh=with_bvh)
    cam = world.camera_state(aspect=config.width / config.height)
    rc, rd = _raster(world, cam, config)
    frame = Renderer(config).render(scene, cam, seed=seed, raster_color=rc,
                                    raster_depth=rd)
    return np.asarray(frame.image), np.asarray(frame.rt_depth)


def oracle_world(world, config: RenderConfig, seed: int, scalar: bool = False):
    """The NumPy oracle's ``(image, rt_depth)`` for the same frame as
    :func:`render_world`. ``scalar`` selects the per-pixel oracle."""
    w, h = config.width, config.height
    centers, radii, mats, camera = oracle_inputs_from_world(world)
    camera["aspect"] = w / h
    kw = dict(defocus=config.defocus, diffuse_sampling=config.diffuse_sampling)
    meshes = world.extract_meshes_host(first_material_id=len(radii))
    if meshes is not None:
        va, vb, vc, tri_mids, tri_mats = meshes
        mats = np.concatenate([mats, tri_mats], axis=0)
        kw["triangles"] = (va, vb, vc, tri_mids)
    if config.level < 3 and world.n_raster:
        rc, rd = _raster(world, world.camera_state(aspect=w / h), config)
        kw["raster_color"] = np.stack(
            [np.asarray(c).reshape(h, w) for c in (rc.x, rc.y, rc.z)], axis=-1)
        kw["raster_depth"] = np.asarray(rd).reshape(h, w)
    oracle = render_oracle if scalar else render_oracle_fast
    return oracle(centers, radii, mats, camera, w, h, config.samples_per_pixel,
                  config.bounces, config.level, seed, **kw)


@dataclasses.dataclass(frozen=True)
class GoldenCase:
    """One renderer-vs-oracle frame and its tolerances."""

    name: str
    make_world: Callable
    width: int
    height: int
    spp: int
    bounces: int
    level: int
    seed: int
    mean_tol: float = 2e-3
    max_outlier_frac: float = 0.01
    defocus: bool = False
    diffuse_sampling: str = "reference"
    scalar_oracle: bool = False

    def config(self, intersect_backend: str = "brute") -> RenderConfig:
        return RenderConfig(width=self.width, height=self.height,
                            samples_per_pixel=self.spp, bounces=self.bounces,
                            level=self.level, defocus=self.defocus,
                            diffuse_sampling=self.diffuse_sampling,
                            intersect_backend=intersect_backend)


def run_case(case: GoldenCase, intersect_backend: str = "brute",
             world: Optional[object] = None) -> dict:
    """Render ``case`` on the default device and hold it to the oracle.
    Returns the metrics with their limits; raises AssertionError past them."""
    world = world if world is not None else case.make_world()
    config = case.config(intersect_backend)
    got, got_depth = render_world(world, config, case.seed)
    want, want_depth = oracle_world(world, config, case.seed,
                                    scalar=case.scalar_oracle)
    m = assert_images_match(got, want, mean_tol=case.mean_tol,
                            max_outlier_frac=case.max_outlier_frac)
    return {**m, "mean_tol": case.mean_tol,
            "max_outlier_frac": case.max_outlier_frac,
            "got_depth": got_depth, "want_depth": want_depth}


# -- the golden scenes --------------------------------------------------------

def defocus_emissive_world():
    """Thin-lens defocus plus an emissive sphere over a grey ground."""
    from ..scene.components import (RaytracedCamera, RaytracedSphere, Raytracing,
                                    StandardMaterial, Transform)
    from ..scene.world import World

    w = World()
    w.set_camera(Transform.from_xyz(0, 1.0, 5).looking_at((0, 0.5, 0)),
                 camera=RaytracedCamera(level=Raytracing.PURE, aperture=0.25,
                                        focus_distance=5.0))
    w.spawn_sphere(Transform.from_xyz(0, -1000, 0), RaytracedSphere(1000.0),
                   StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_sphere(Transform.from_xyz(0, 0.5, 0), RaytracedSphere(0.5),
                   StandardMaterial(base_color=(0.0, 0.0, 0.0),
                                    emissive=(4.0, 2.0, 1.0)))
    w.spawn_sphere(Transform.from_xyz(-1.5, 0.5, -2.0), RaytracedSphere(0.5),
                   StandardMaterial(base_color=(0.2, 0.4, 0.8)))
    return w


def cube_mesh_world():
    """A metal triangle-mesh cube beside a red sphere."""
    from ..scene.components import (RaytracedCamera, RaytracedSphere, Raytracing,
                                    StandardMaterial, Transform, cube_mesh)
    from ..scene.world import World

    w = World()
    w.set_camera(Transform.from_xyz(0, 0.8, 5).looking_at((0, 0.5, 0)),
                 camera=RaytracedCamera(level=Raytracing.PURE))
    w.spawn_sphere(Transform.from_xyz(0, -1000, 0), RaytracedSphere(1000.0),
                   StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_sphere(Transform.from_xyz(-1.3, 0.5, 0), RaytracedSphere(0.5),
                   StandardMaterial(base_color=(0.8, 0.2, 0.2)))
    w.spawn_mesh(Transform.from_xyz(0.9, 0.5, 0), cube_mesh(1.0),
                 StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                  perceptual_roughness=0.1))
    return w


def _simple():
    from ..scene import rtiow
    return rtiow.simple_scene()


def _material():
    from ..scene import rtiow
    return rtiow.material_test_scene()


def _final_small():
    from ..scene import rtiow
    return rtiow.final_scene(seed=5, grid=2)


GLASS_METAL = dict(mean_tol=4e-3, max_outlier_frac=0.02)

GOLDEN_CASES = {
    "simple-L3": GoldenCase("simple-L3", _simple, 96, 96, 4, 8, 3, 7),
    "simple-L2": GoldenCase("simple-L2", _simple, 96, 96, 4, 8, 2, 7),
    "material": GoldenCase("material", _material, 96, 96, 4, 8, 3, 3,
                           **GLASS_METAL),
    "final-grid2": GoldenCase("final-grid2", _final_small, 80, 80, 4, 4, 3, 11,
                              **GLASS_METAL),
    "defocus-emissive": GoldenCase("defocus-emissive", defocus_emissive_world,
                                   64, 64, 4, 4, 3, 9, defocus=True,
                                   **GLASS_METAL),
    "cube-mesh": GoldenCase("cube-mesh", cube_mesh_world, 40, 40, 2, 4, 3, 6,
                            scalar_oracle=True, **GLASS_METAL),
}

# Scenes of the scene × level × backend matrix (tests/test_oracle_matrix.py).
MATRIX_SCENES = {
    "simple": _simple,
    "material": _material,
    "final-grid2": _final_small,
    "defocus-emissive": defocus_emissive_world,
    "cube-mesh": cube_mesh_world,
}
