"""Triangle-mesh primitive (extension, BASELINE config 5): Möller–Trumbore
intersection, merged sphere+mesh scenes, hybrid-mode occlusion, depth."""

import numpy as np
import pytest

from bevyray_tpu import (RenderConfig, Renderer, RaytracedCamera, RaytracedSphere,
                         Raytracing, StandardMaterial, Transform)
from bevyray_tpu.scene.components import RaytracedMesh, cube_mesh
from bevyray_tpu.scene.world import World


def _camera_world():
    w = World()
    w.set_camera(Transform.from_xyz(0, 0.5, 6).looking_at((0, 0.5, 0)),
                 camera=RaytracedCamera(level=Raytracing.PURE))
    return w


def test_single_triangle_hit_region_and_depth():
    w = _camera_world()
    tri = RaytracedMesh(
        vertices=np.array([[-1, -0.5, 0], [1, -0.5, 0], [0, 1.5, 0]], np.float32),
        indices=np.array([[0, 1, 2]], np.int32))
    w.spawn_mesh(Transform.from_xyz(0, 0, 0), tri,
                 StandardMaterial(base_color=(1.0, 0.1, 0.1)))
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=2, bounces=2, level=3)
    frame = Renderer(cfg).render(w.extract(with_bvh=False),
                                 w.camera_state(aspect=1.0), seed=1)
    img = np.asarray(frame.image)
    depth = np.asarray(frame.rt_depth)
    # Center of the triangle: red-ish hit at distance 6.
    assert img[22, 24, 0] > 0.3 and img[22, 24, 1] < 0.15
    assert abs(depth[22, 24] - 6.0) < 0.05
    # Corners: sky.
    assert img[2, 2, 2] > 0.9
    assert depth[2, 2] > 900


def test_cube_occludes_sphere():
    """The reference app's cube (main.rs:76-85) as raytraced geometry: placed in
    front of a sphere, it must occlude it; behind, the sphere wins."""
    for cube_z, expect_cube in [(2.0, True), (-4.0, False)]:
        w = _camera_world()
        w.spawn_sphere(Transform.from_xyz(0, 0.5, 0), RaytracedSphere(0.8),
                       StandardMaterial(base_color=(0.1, 0.9, 0.1)))
        w.spawn_mesh(Transform.from_xyz(0, 0.5, cube_z), cube_mesh(1.2),
                     StandardMaterial(base_color=(0.9, 0.1, 0.1)))
        cfg = RenderConfig(width=32, height=32, samples_per_pixel=4, bounces=2,
                           level=3)
        img = np.asarray(Renderer(cfg).render(w.extract(with_bvh=False),
                                              w.camera_state(aspect=1.0),
                                              seed=2).image)
        center = img[16, 16]
        if expect_cube:
            assert center[0] > center[1], f"cube in front: {center}"
        else:
            assert center[1] > center[0], f"sphere in front: {center}"


def test_mesh_materials_share_table_with_spheres():
    """Mesh materials append after per-sphere records; ids must resolve."""
    w = _camera_world()
    w.spawn_sphere(Transform.from_xyz(-1.5, 0.5, 0), RaytracedSphere(0.5),
                   StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(Transform.from_xyz(1.2, 0.5, 0), cube_mesh(1.0),
                 StandardMaterial(base_color=(1, 1, 0)))
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=4, bounces=2, level=3)
    img = np.asarray(Renderer(cfg).render(w.extract(with_bvh=False),
                                          w.camera_state(aspect=1.0), seed=3).image)
    # Sphere on the left is blue; cube on the right is yellow.
    left = img[24, 12]
    right = img[24, 36]
    assert left[2] > left[0] and left[2] > left[1], left
    assert right[0] > 0.3 and right[1] > 0.3 and right[2] < 0.2, right


def test_metallic_cube_reflects():
    w = _camera_world()
    w.spawn_sphere(Transform.from_xyz(0, -1000, 0), RaytracedSphere(999.6),
                   StandardMaterial(base_color=(0.5, 0.5, 0.5)))
    w.spawn_mesh(Transform.from_xyz(0, 0.7, 0), cube_mesh(1.4),
                 StandardMaterial(base_color=(0.9, 0.9, 0.9), metallic=1.0,
                                  perceptual_roughness=0.0))
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=8, bounces=4, level=3)
    img = np.asarray(Renderer(cfg).render(w.extract(with_bvh=False),
                                          w.camera_state(aspect=1.0), seed=4).image)
    assert np.isfinite(img).all()
    # The front face mirrors whatever is behind the camera (sky) — bright-ish.
    assert img[18, 16].mean() > 0.3
