"""Multi-device tests on the 8-device virtual CPU mesh: the sharded frame step must
compile, execute, and agree with the single-device renderer."""

import jax
import numpy as np
import pytest

from bevyray_tpu import RenderConfig, Renderer, rtiow
from bevyray_tpu.parallel.sharding import (default_mesh_shape, make_mesh,
                                           render_frame_sharded)


@pytest.fixture(scope="module")
def world_and_scene():
    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    return world, scene, cam


def _single(scene, cam, cfg, seed):
    return np.asarray(Renderer(cfg).render(scene, cam, seed=seed).image)


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (2, 2, 2), (1, 4, 2), (1, 1, 8)])
def test_sharded_matches_single_device(world_and_scene, mesh_shape):
    _, scene, cam = world_and_scene
    sp, dp, tp = mesh_shape
    mesh = make_mesh(sp, dp, tp)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=4, bounces=4, level=3)
    want = _single(scene, cam, cfg, seed=5)
    got = np.asarray(
        render_frame_sharded(mesh, scene, cam, cfg, frame_seed=5).image)
    # Same RNG contract and same math — only reduction order may differ (psum).
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_hybrid_level(world_and_scene):
    _, scene, cam = world_and_scene
    mesh = make_mesh(*default_mesh_shape(len(jax.devices())))
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=2, level=2)
    want = _single(scene, cam, cfg, seed=3)
    got = np.asarray(
        render_frame_sharded(mesh, scene, cam, cfg, frame_seed=3).image)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_default_mesh_shape():
    assert default_mesh_shape(8) == (2, 2, 2)
    assert default_mesh_shape(4) == (2, 2, 1)
    assert default_mesh_shape(1) == (1, 1, 1)
    for n in (1, 2, 4, 8, 16):
        sp, dp, tp = default_mesh_shape(n)
        assert sp * dp * tp == n


def test_sharded_per_pixel_raster_inputs(world_and_scene):
    """Per-pixel raster color/depth arrays (the hybrid G-buffer case) must work
    through the sharded step — composite runs outside shard_map, so the
    raster layer needs no replicated spec against sharded pixels."""
    import jax.numpy as jnp

    from bevyray_tpu.core.vec import Vec3

    _, scene, cam = world_and_scene
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=3,
                       level=2)
    n = cfg.n_pixels
    # A raster layer covering the left half of the frame, very near the camera.
    px = np.arange(n) % cfg.width
    in_left = px < cfg.width // 2
    rd = jnp.asarray(np.where(in_left, 0.9, 0.0).astype(np.float32))
    rc = Vec3(jnp.asarray(np.where(in_left, 1.0, 0.0).astype(np.float32)),
              jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))

    want = np.asarray(Renderer(cfg).render(
        scene, cam, seed=5, raster_color=rc, raster_depth=rd).image)

    got_xla = render_frame_sharded(make_mesh(2, 2, 2), scene, cam, cfg, 5,
                                   raster_color=rc, raster_depth=rd)
    np.testing.assert_allclose(np.asarray(got_xla.image), want, atol=1e-4)



@pytest.mark.parametrize("mesh_shape", [(4, 1, 1), (2, 2, 1), (1, 4, 1),
                                        (1, 2, 2)])
def test_four_device_meshes_match_single_device(mesh_shape):
    """The meshes of ``chip_smoke.py --four-cards`` on a 4-device sub-mesh:
    each equal to single-device ``Renderer`` (the final scene's 512-entry
    table splits evenly over tp)."""
    world = rtiow.final_scene(seed=42, grid=3)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=40 / 24)
    cfg = RenderConfig(width=40, height=24, samples_per_pixel=4, bounces=3,
                       level=3)
    want = Renderer(cfg).render(scene, cam, seed=7)
    got = render_frame_sharded(make_mesh(*mesh_shape), scene, cam, cfg, 7)
    np.testing.assert_allclose(np.asarray(got.image), np.asarray(want.image),
                               atol=1e-5)
    assert float(got.rays_traced) == float(want.rays_traced)
    assert len(got.image.sharding.device_set) == 4


def test_sharded_sp_hybrid_raster_layer():
    """Level 2 with the final scene's raster cube, pixel rows over 4 devices."""
    from bevyray_tpu.engine.raster import raster_layer

    world = rtiow.final_scene(seed=5, grid=2)
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=3,
                       level=2)
    rc, rd = raster_layer(world, cam, cfg)
    want = Renderer(cfg).render(scene, cam, seed=3, raster_color=rc,
                                raster_depth=rd)
    got = render_frame_sharded(make_mesh(4, 1, 1), scene, cam, cfg, 3,
                               raster_color=rc, raster_depth=rd)
    np.testing.assert_allclose(np.asarray(got.image), np.asarray(want.image),
                               atol=1e-5)


def test_sharded_sp_triangle_scene():
    """A traced triangle mesh beside spheres, pixel rows over 4 devices."""
    from bevyray_tpu.testing.parity import cube_mesh_world

    world = cube_mesh_world()
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=3,
                       level=3)
    want = Renderer(cfg).render(scene, cam, seed=6)
    got = render_frame_sharded(make_mesh(4, 1, 1), scene, cam, cfg, 6)
    np.testing.assert_allclose(np.asarray(got.image), np.asarray(want.image),
                               atol=1e-5)
    assert float(got.rays_traced) == float(want.rays_traced)
