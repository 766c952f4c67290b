"""Adaptive sampling (engine/adaptive.py + the XLA step's per-pixel sample
targets): tolerance 0 must reproduce uniform progressive accumulation
draw-for-draw; a positive tolerance must stop converged pixels while keeping
the estimate unbiased."""

import numpy as np

from bevyray_tpu import RenderConfig, rtiow
from bevyray_tpu.engine.adaptive import AdaptiveRenderer
from bevyray_tpu.engine.film import ProgressiveRenderer


def _scene():
    world = rtiow.material_test_scene()
    return world.extract(with_bvh=False), world.camera_state(aspect=1.0)


def test_tolerance_zero_matches_uniform_progressive():
    scene, cam = _scene()
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=2, bounces=3,
                       level=3)
    prog = ProgressiveRenderer(cfg)
    adap = AdaptiveRenderer(cfg, tolerance=0.0)
    for i in range(3):
        f_ref = prog.step(scene, cam, seed=i)
        adap.step(scene, cam, seed=i)
    f = adap.resolve(cam)
    assert float(adap.film.n_samples.min()) == 6.0
    np.testing.assert_allclose(np.asarray(f.image), np.asarray(f_ref.image),
                               atol=1e-5)
    assert float(f.rays_traced) == float(f_ref.rays_traced)


def test_adaptive_stops_converged_pixels_and_stays_unbiased():
    scene, cam = _scene()
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=2, bounces=3,
                       level=3)
    # reprobe_every=0: this test pins the PURE stop-on-converged accounting
    # (re-probe recovery has its own tests below).
    adap = AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=0)
    for i in range(5):
        adap.step(scene, cam, seed=i)
    counts = adap.samples_map()
    # Some pixels stopped early, none exceeded the budget, and sampling
    # focused on the noisy ones (sky converges fastest in this scene).
    assert counts.max() == 5 * cfg.samples_per_pixel
    assert counts.min() >= 2 * cfg.samples_per_pixel  # warmup + second look
    assert (counts < counts.max()).mean() > 0.2
    assert adap.converged_fraction() > 0.2

    # Fewer rays than uniform for the same pass count...
    uni = AdaptiveRenderer(cfg, tolerance=0.0, reprobe_every=0)
    for i in range(5):
        uni.step(scene, cam, seed=i)
    assert (float(adap.film.rays_traced)
            < 0.9 * float(uni.film.rays_traced))

    # ...while the estimate stays close to the uniform one (stopped pixels are
    # exactly the ones whose estimate had settled).
    a = np.asarray(adap.resolve(cam).image)
    u = np.asarray(uni.resolve(cam).image)
    assert float(np.abs(a - u).mean()) < 0.02


def test_spp_map_roundtrip():
    """The pass's per-pixel sample targets are laid out row-major: exactly the
    pixels still above tolerance (an asymmetric pattern here) gain samples and
    change, every other pixel keeps its sums bit for bit."""
    import jax.numpy as jnp

    scene, cam = _scene()
    cfg = RenderConfig(width=20, height=12, samples_per_pixel=2, bounces=2,
                       level=3)
    adap = AdaptiveRenderer(cfg, tolerance=0.5, reprobe_every=0)
    adap.step(scene, cam, seed=0)
    pattern = np.zeros((12, 20), bool)
    pattern[1, 3:9] = True
    pattern[7:10, 15] = True
    adap.film = adap.film._replace(err=jnp.asarray(
        np.where(pattern.ravel(), 1.0, 0.0).astype(np.float32)))
    before = np.asarray(adap.film.color_sum.x).reshape(12, 20).copy()
    adap.step(scene, cam, seed=1)
    np.testing.assert_array_equal(adap.samples_map(), 2.0 + 2.0 * pattern)
    after = np.asarray(adap.film.color_sum.x).reshape(12, 20)
    np.testing.assert_array_equal(after[~pattern], before[~pattern])
    assert (after[pattern] != before[pattern]).mean() > 0.5


def test_cli_adaptive_accumulate(tmp_path):
    from bevyray_tpu.app.cli import main
    out = tmp_path / "a.png"
    rc = main(["accumulate", "--scene", "material", "--width", "48",
               "--height", "48", "--spp", "2", "--passes", "3",
               "--adaptive-tolerance", "0.05",
               "--out", str(out)])
    assert rc == 0 and out.exists()


def test_adaptive_checkpoint_resume(tmp_path):
    scene, cam = _scene()
    cfg = RenderConfig(width=48, height=48, samples_per_pixel=2, bounces=2,
                       level=3)
    a = AdaptiveRenderer(cfg, tolerance=0.05)
    a.step(scene, cam, seed=0)
    a.step(scene, cam, seed=1)
    path = str(tmp_path / "a.npz")
    a.save(path)

    b = AdaptiveRenderer(cfg, tolerance=0.05)
    b.load(path)
    a.step(scene, cam, seed=2)
    b.step(scene, cam, seed=2)
    np.testing.assert_array_equal(np.asarray(a.resolve(cam).image),
                                  np.asarray(b.resolve(cam).image))

    import pytest
    wrong = AdaptiveRenderer(RenderConfig(width=32, height=32,
                                          samples_per_pixel=2, bounces=2,
                                          level=3), tolerance=0.05)
    with pytest.raises(ValueError, match="checkpoint"):
        wrong.load(path)


def test_camera_change_resets_film_and_shortlists():
    # The film is viewpoint-specific: moving the camera must reset it, not
    # mix two viewpoints' samples.
    from bevyray_tpu.scene.components import (PerspectiveProjection,
                                              RaytracedCamera, Transform)
    world = rtiow.material_test_scene()
    scene = world.extract(with_bvh=False)
    cam_a = world.camera_state(aspect=1.0)
    world.set_camera(Transform.from_xyz(2.0, 1.5, 6.0).looking_at((0, 0.5, 0)),
                     PerspectiveProjection(), RaytracedCamera())
    cam_b = world.camera_state(aspect=1.0)

    cfg = RenderConfig(width=48, height=48, samples_per_pixel=2, bounces=2,
                       level=3)
    moved = AdaptiveRenderer(cfg, tolerance=0.0)
    moved.step(scene, cam_a, seed=0)
    moved.step(scene, cam_b, seed=0)       # must reset, not mix viewpoints
    fresh = AdaptiveRenderer(cfg, tolerance=0.0)
    fresh.step(scene, cam_b, seed=0)
    np.testing.assert_array_equal(np.asarray(moved.resolve(cam_b).image),
                                  np.asarray(fresh.resolve(cam_b).image))


def test_reprobe_recovers_artificially_frozen_pixels():
    # A pixel whose pass once agreed by chance must not under-sample forever:
    # the periodic re-probe pass force-samples stopped pixels and folds the new
    # disagreement into err, un-freezing any that were still noisy.
    import jax.numpy as jnp

    scene, cam = _scene()
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=2, bounces=3,
                       level=3)
    adap = AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=2)
    adap.step(scene, cam, seed=0)
    adap.step(scene, cam, seed=1)
    # Artificially freeze EVERY pixel (as if each had one lucky agreeing pass).
    adap.film = adap.film._replace(err=jnp.zeros_like(adap.film.err))
    assert adap.converged_fraction() == 1.0
    before = adap.samples_map().copy()

    adap.step(scene, cam, seed=2)   # _pass_count == 2 → re-probe pass
    after = adap.samples_map()
    # Everything re-sampled once...
    np.testing.assert_array_equal(after, before + cfg.samples_per_pixel)
    # ...and the genuinely noisy pixels recovered (err re-measured above
    # tolerance), while converged ones re-froze.
    frac = adap.converged_fraction()
    assert 0.01 < 1.0 - frac, "no pixel un-froze — recovery is broken"
    assert frac > 0.05, "re-probe should re-freeze genuinely converged pixels"

    # The next (non-reprobe) pass samples exactly the recovered pixels.
    adap.step(scene, cam, seed=3)
    sampled = adap.samples_map() - after
    recovered = 1.0 - frac
    got = (sampled > 0).mean()
    np.testing.assert_allclose(got, recovered, atol=1e-6)


def test_reprobe_keeps_density_shape_on_converged_scene():
    # On a scene that is genuinely converged (sky-only view: every pass agrees
    # to within tolerance) the re-probe must add only a uniform sample floor —
    # the allocation SHAPE (all-equal) is unchanged.
    from bevyray_tpu.scene.components import Transform
    from bevyray_tpu.scene.world import World

    world = World()                     # no entities: pure sky gradient
    world.set_camera(Transform.from_xyz(0.0, 0.0, 0.0).looking_at((0, 0, -1)))
    scene = world.extract(with_bvh=False)
    cam = world.camera_state(aspect=1.0)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2, bounces=2,
                       level=3)
    adap = AdaptiveRenderer(cfg, tolerance=0.05, reprobe_every=2)
    for i in range(5):                  # passes 2 and 4 are re-probes
        adap.step(scene, cam, seed=i)
    counts = adap.samples_map()
    assert counts.min() == counts.max()   # uniform: warmup+2nd look+2 reprobes
    assert counts.max() == 4 * cfg.samples_per_pixel
    assert adap.converged_fraction() == 1.0
