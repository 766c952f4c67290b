"""Input validation: bad configuration fails at CONSTRUCTION with an
actionable message, not as an opaque shape error inside jit (VERDICT r01
"failure detection" gap)."""

import pytest

from bevyray_tpu import RenderConfig


@pytest.mark.parametrize("kwargs,match", [
    (dict(width=0, height=64), "frame size"),
    (dict(width=64, height=-1), "frame size"),
    (dict(width=64, height=64, samples_per_pixel=0), "samples_per_pixel"),
    (dict(width=64, height=64, bounces=-1), "bounces"),
    (dict(width=64, height=64, level=4), "level"),
    (dict(width=64, height=64, sphere_chunk=0), "sphere_chunk"),
    (dict(width=64, height=64, intersect_backend="gpu"), "intersect_backend"),
    (dict(width=64, height=64, diffuse_sampling="uniform"),
     "diffuse_sampling"),
])
def test_bad_config_raises(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RenderConfig(**kwargs)


def test_good_config_constructs():
    RenderConfig(width=64, height=64, samples_per_pixel=1, bounces=0, level=0)


def test_bad_sphere_raises():
    from bevyray_tpu.scene.components import (RaytracedSphere,
                                              StandardMaterial, Transform)
    from bevyray_tpu.scene.world import World

    w = World()
    with pytest.raises(ValueError, match="finite"):
        w.spawn_sphere(Transform.from_xyz(0.0, float("nan"), 0.0),
                       RaytracedSphere(1.0), StandardMaterial())
    with pytest.raises(ValueError, match="finite"):
        w.spawn_sphere(Transform.from_xyz(0.0, 0.0, 0.0),
                       RaytracedSphere(float("inf")), StandardMaterial())
    # negative radius (hollow glass) stays legal
    w.spawn_sphere(Transform.from_xyz(0.0, 0.0, 0.0), RaytracedSphere(-0.5),
                   StandardMaterial())


def test_degenerate_camera_raises():
    from bevyray_tpu.scene.components import Transform
    from bevyray_tpu.scene.world import World

    w = World()
    w.camera_transform = Transform.from_xyz(1.0, 2.0, 3.0).looking_at(
        (1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="degenerate"):
        w.camera_state(aspect=1.0)


def test_up_axis_camera_raises():
    from bevyray_tpu.scene.components import Transform
    from bevyray_tpu.scene.world import World

    w = World()
    # looking straight up: forward parallel to the up axis -> NaN basis
    w.camera_transform = Transform.from_xyz(0.0, 0.0, 0.0).looking_at(
        (0.0, 5.0, 0.0))
    with pytest.raises(ValueError, match="degenerate"):
        w.camera_state(aspect=1.0)
