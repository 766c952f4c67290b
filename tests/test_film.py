"""Progressive accumulation: film refines toward the high-spp estimate, resets on
camera move, and matches the one-shot renderer when sample streams align."""

import numpy as np

from bevyray_tpu import RenderConfig, Renderer, rtiow
from bevyray_tpu.engine.film import ProgressiveRenderer
from bevyray_tpu.scene.components import Transform


def test_two_passes_equal_one_double_spp_render():
    """2 passes × 2 spp must bit-match 1 render × 4 spp with the same seed: the
    film offsets sample indices so streams line up exactly."""
    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)

    cfg2 = RenderConfig(width=24, height=24, samples_per_pixel=2, bounces=4, level=3)
    prog = ProgressiveRenderer(cfg2)
    prog.step(scene, cam, seed=9)
    frame = prog.step(scene, cam, seed=9)

    cfg4 = RenderConfig(width=24, height=24, samples_per_pixel=4, bounces=4, level=3)
    want = Renderer(cfg4).render(scene, cam, seed=9)
    np.testing.assert_allclose(np.asarray(frame.image), np.asarray(want.image),
                               atol=1e-6)
    assert prog.samples_accumulated == 4


def test_reset_on_camera_move():
    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1, bounces=2, level=3)
    prog = ProgressiveRenderer(cfg)
    cam1 = world.camera_state(aspect=1.0)
    prog.step(scene, cam1, seed=1)
    prog.step(scene, cam1, seed=2)
    assert prog.samples_accumulated == 2

    world.set_camera(Transform.from_xyz(0.5, 0.5, 4.0).looking_at((0, 0.5, 0)))
    cam2 = world.camera_state(aspect=1.0)
    prog.step(scene, cam2, seed=3)
    assert prog.samples_accumulated == 1   # film was reset


def test_variance_decreases_with_accumulation():
    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=2, bounces=4, level=3)

    prog = ProgressiveRenderer(cfg)
    first = np.asarray(prog.step(scene, cam, seed=1).image)
    last = first
    for i in range(7):
        last = np.asarray(prog.step(scene, cam, seed=2 + i).image)

    # Reference: a much higher-spp estimate.
    hi = RenderConfig(width=24, height=24, samples_per_pixel=32, bounces=4, level=3)
    ref = np.asarray(Renderer(hi).render(scene, cam, seed=99).image)
    err_first = np.abs(first - ref).mean()
    err_last = np.abs(last - ref).mean()
    assert err_last < err_first


def test_load_rejects_mismatched_resolution(tmp_path):
    """A checkpoint taken at one geometry must not resume into another, even when
    the pixel counts match (would silently garble the image otherwise)."""
    import pytest

    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = RenderConfig(width=24, height=12, samples_per_pixel=1, bounces=2, level=3)
    prog = ProgressiveRenderer(cfg)
    prog.step(scene, cam, seed=1)
    path = str(tmp_path / "film.npz")
    prog.save(path)

    swapped = RenderConfig(width=12, height=24, samples_per_pixel=1, bounces=2,
                           level=3)
    other = ProgressiveRenderer(swapped)
    with pytest.raises(ValueError, match="24x12"):
        other.load(path, cam)

    # Same geometry resumes fine.
    again = ProgressiveRenderer(cfg)
    again.load(path, cam)
    assert again.samples_accumulated == 1
