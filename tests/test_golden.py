"""Golden-image tests: JAX wavefront renderer vs the independent NumPy oracle.

Both implementations consume identical RNG draws (the slot contract), so they
compute the same estimate; disagreement is limited to libm differences (~1e-5 per
op), which can chaotically flip a hit/branch decision on a measure-zero set of rays.
Comparisons therefore use robust metrics (``bevyray_tpu.testing.parity``, shared
with the on-card run of ``chip_smoke.py``): mean error tight, plus a small
allowance of outlier pixels.
"""

import numpy as np
import pytest

from bevyray_tpu import RenderConfig, Renderer, rtiow
from bevyray_tpu.testing.oracle import (oracle_inputs_from_world, render_oracle,
                                        render_oracle_fast)
from bevyray_tpu.testing.parity import (GOLDEN_CASES, GoldenCase,
                                        assert_images_match, oracle_world,
                                        render_world, run_case)


def test_fast_oracle_is_the_scalar_oracle():
    """The pixel-vectorized oracle must reproduce the scalar per-pixel oracle to
    float ulps on every code path (sky, all 3 materials, depth) — this is what
    lets the golden tests below run at 96²/4spp."""
    world = rtiow.final_scene(seed=5, grid=2)
    centers, radii, mats, camera = oracle_inputs_from_world(world)
    a, da = render_oracle(centers, radii, mats, camera, 24, 24, 2, 4, 3, 11)
    b, db = render_oracle_fast(centers, radii, mats, camera, 24, 24, 2, 4, 3, 11)
    np.testing.assert_allclose(a, b, atol=2e-5)
    np.testing.assert_allclose(da, db, rtol=1e-4)   # summation-order ulps


@pytest.mark.parametrize("level", [3, 2])
def test_simple_scene_matches_oracle(level):
    """BASELINE config 1: Lambertian spheres + ground."""
    m = run_case(GOLDEN_CASES[f"simple-L{level}"])
    got_depth, want_depth = m["got_depth"], m["want_depth"]
    # Depth: compare where both agree it's a hit (miss fallback is huge).
    both_hit = (want_depth < 900) & (got_depth < 900)
    assert both_hit.mean() > 0.5
    np.testing.assert_allclose(got_depth[both_hit], want_depth[both_hit], atol=1e-2)


def test_material_scene_matches_oracle():
    """BASELINE config 2: metal fuzz + dielectric with Schlick."""
    run_case(GOLDEN_CASES["material"])


def test_final_scene_small_matches_oracle():
    """A shrunk RTiOW final scene (grid=2 → ~30 spheres), all material kinds."""
    run_case(GOLDEN_CASES["final-grid2"])


def test_defocus_emissive_combo_matches_oracle():
    """Two extensions combined (defocus blur + emissive lighting) against the
    oracle."""
    run_case(GOLDEN_CASES["defocus-emissive"])


def test_cosine_sampling_matches_oracle():
    """The cosine-weighted diffuse extension draw-for-draw vs the oracle."""
    run_case(GoldenCase("cosine", rtiow.material_test_scene, 64, 64, 4, 6, 3,
                        13, mean_tol=4e-3, max_outlier_frac=0.02,
                        diffuse_sampling="cosine"))


def test_skip_level_passthrough():
    """Level 0 returns the raster layer untouched (raytrace.wgsl:97-99)."""
    world = rtiow.simple_scene()
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1, bounces=1, level=0)
    r = Renderer(cfg)
    frame = r.render(world.extract(with_bvh=False),
                     world.camera_state(aspect=1.0), seed=0)
    np.testing.assert_allclose(np.asarray(frame.image), 1.0)


def test_mesh_scene_matches_oracle():
    """Triangle meshes against the independent oracle (oracle's serial
    control-flow + its own Möller–Trumbore)."""
    run_case(GOLDEN_CASES["cube-mesh"])


def test_hollow_glass_matches_oracle():
    """Negative-radius inner shell (RTiOW hollow-glass trick; hit_sphere only
    squares r, wgsl:375) — both brute-force and BVH backends vs the oracle."""
    from bevyray_tpu import (RaytracedCamera, RaytracedSphere, Raytracing,
                             StandardMaterial, Transform)
    from bevyray_tpu.scene.world import World

    w = World()
    w.set_camera(Transform.from_xyz(0, 0.6, 4).looking_at((0, 0.5, 0)),
                 camera=RaytracedCamera(level=Raytracing.PURE))
    w.spawn_sphere(Transform.from_xyz(0, -1000, 0), RaytracedSphere(1000.0),
                   StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    glass = StandardMaterial(base_color=(1.0, 1.0, 1.0), ior=1.5,
                             specular_transmission=1.0)
    w.spawn_sphere(Transform.from_xyz(0, 0.5, 0), RaytracedSphere(0.5), glass)
    w.spawn_sphere(Transform.from_xyz(0, 0.5, 0), RaytracedSphere(-0.4), glass)
    w.spawn_sphere(Transform.from_xyz(-1.2, 0.5, 0), RaytracedSphere(0.5),
                   StandardMaterial(base_color=(0.9, 0.3, 0.2)))

    centers, radii, mats, camera = oracle_inputs_from_world(w)
    camera["aspect"] = 1.0
    want, _ = render_oracle(centers, radii, mats, camera, 32, 32, 2, 6, 3, 4)

    cam = w.camera_state(aspect=1.0)
    for backend, with_bvh in (("brute", False), ("bvh", True)):
        cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=6,
                           level=3, intersect_backend=backend)
        frame = Renderer(cfg).render(w.extract(with_bvh=with_bvh), cam, seed=4)
        assert_images_match(np.asarray(frame.image), want, mean_tol=4e-3,
                             max_outlier_frac=0.02)


def test_kitchen_sink_hybrid_all_features_vs_oracle():
    """Everything at once — hybrid level 2 with the analytic raster cube,
    a traced triangle mesh, an emissive sphere, hollow glass, thin-lens
    defocus, and cosine diffuse sampling — XLA vs the vectorized oracle.
    Pins the feature INTERACTIONS no single-feature golden covers."""
    from bevyray_tpu import (RaytracedCamera, RaytracedSphere, Raytracing,
                             StandardMaterial, Transform, cube_mesh)
    from bevyray_tpu.scene.world import World

    w = World()
    w.set_camera(Transform.from_xyz(0, 1.0, 5).looking_at((0, 0.5, 0)),
                 camera=RaytracedCamera(level=Raytracing.FALLBACK_RAYTRACED,
                                        aperture=0.2, focus_distance=5.0))
    w.spawn_sphere(Transform.from_xyz(0, -1000, 0), RaytracedSphere(1000.0),
                   StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    glass = StandardMaterial(base_color=(1.0, 1.0, 1.0), ior=1.5,
                             specular_transmission=1.0)
    w.spawn_sphere(Transform.from_xyz(-1.4, 0.5, 0.3), RaytracedSphere(0.5),
                   glass)
    w.spawn_sphere(Transform.from_xyz(-1.4, 0.5, 0.3), RaytracedSphere(-0.4),
                   glass)
    w.spawn_sphere(Transform.from_xyz(1.6, 0.7, -1.0), RaytracedSphere(0.7),
                   StandardMaterial(base_color=(0.0, 0.0, 0.0),
                                    emissive=(3.0, 1.5, 0.7)))
    w.spawn_mesh(Transform.from_xyz(0.8, 0.4, 0.8), cube_mesh(0.8),
                 StandardMaterial(base_color=(0.2, 0.5, 0.9), metallic=1.0,
                                  perceptual_roughness=0.05))
    w.spawn_raster_mesh(Transform.from_xyz(0.0, 0.5, -0.4), cube_mesh(1.0),
                        StandardMaterial(base_color=(0.8, 0.7, 0.6)))

    cfg = RenderConfig(width=48, height=48, samples_per_pixel=3, bounces=4,
                       level=2, defocus=True, diffuse_sampling="cosine")
    got, _ = render_world(w, cfg, seed=21)
    want, _ = oracle_world(w, cfg, seed=21)
    assert_images_match(got, want, mean_tol=4e-3, max_outlier_frac=0.02)
