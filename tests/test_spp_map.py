"""Per-pixel sample targets on the XLA step (``spp_map`` of ``render_impl``
and ``film.accumulate_impl``): a lane whose sample index is at or past its
pixel's target starts dead and adds nothing to color, depth or segments."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bevyray_tpu import RenderConfig, rtiow
from bevyray_tpu.core.vec import Vec3
from bevyray_tpu.engine.film import accumulate_impl, new_film
from bevyray_tpu.engine.renderer import render_impl

W, H, SPP = 24, 16, 4


def _cfg(spp=SPP):
    return RenderConfig(width=W, height=H, samples_per_pixel=spp, bounces=3,
                        level=3)


@pytest.fixture(scope="module")
def scene_cam():
    world = rtiow.material_test_scene()
    return world.extract(with_bvh=False), world.camera_state(aspect=W / H)


def _accumulate(scene_cam, spp_map=None, spp=SPP):
    cfg = _cfg(spp)
    scene, cam = scene_cam
    fn = jax.jit(functools.partial(accumulate_impl, config=cfg))
    f = fn(new_film(cfg), scene, cam, frame_seed=jnp.uint32(4),
           sample_offset=jnp.uint32(0), spp_map=spp_map)
    return jax.tree.map(np.asarray, f)


def _render(scene_cam, spp_map=None, spp=SPP):
    scene, cam = scene_cam
    fn = jax.jit(functools.partial(render_impl, config=_cfg(spp)))
    return fn(scene, cam, frame_seed=jnp.uint32(4),
              raster_color=Vec3.splat(jnp.float32(1.0)),
              raster_depth=jnp.float32(0.0), spp_map=spp_map)


def _map(values, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.choice(values, W * H).astype(np.int32))


def test_all_zero_map_traces_nothing(scene_cam):
    f = _accumulate(scene_cam, jnp.zeros((W * H,), jnp.int32))
    assert float(f.rays_traced) == 0.0
    assert not np.any(np.stack(f.color_sum)) and not np.any(f.depth_sum)
    assert not np.any(f.n_samples)


def test_full_map_matches_uniform_accumulate_bit_for_bit(scene_cam):
    got = _accumulate(scene_cam, jnp.full((W * H,), SPP, jnp.int32))
    want = _accumulate(scene_cam)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.broadcast_to(b, a.shape))


def test_full_map_matches_uniform_render_bit_for_bit(scene_cam):
    got = _render(scene_cam, jnp.full((W * H,), SPP, jnp.int32))
    want = _render(scene_cam)
    np.testing.assert_array_equal(np.asarray(got.image), np.asarray(want.image))
    np.testing.assert_array_equal(np.asarray(got.rt_depth),
                                  np.asarray(want.rt_depth))
    assert float(got.rays_traced) == float(want.rays_traced)


def test_mixed_map_changes_only_chosen_pixels(scene_cam):
    spp_map = _map([0, SPP], seed=1)
    chosen = np.asarray(spp_map) > 0
    got = _accumulate(scene_cam, spp_map)
    want = _accumulate(scene_cam)
    for a, b in zip((*got.color_sum, got.depth_sum),
                    (*want.color_sum, want.depth_sum)):
        np.testing.assert_array_equal(a[chosen], b[chosen])
        assert not np.any(a[~chosen])
    np.testing.assert_array_equal(got.n_samples, np.where(chosen, SPP, 0))


@pytest.mark.parametrize("k", [1, 2])
def test_partial_target_equals_a_k_sample_pass(scene_cam, k):
    """A pixel with target k holds exactly its first k samples; dead lanes add
    no depth (the miss fallback would otherwise land in depth_sum)."""
    spp_map = _map([0, k], seed=2 + k)
    chosen = np.asarray(spp_map) > 0
    got = _accumulate(scene_cam, spp_map)
    want = _accumulate(scene_cam, spp=k)
    np.testing.assert_array_equal(got.depth_sum[chosen], want.depth_sum[chosen])
    assert not np.any(got.depth_sum[~chosen])
    np.testing.assert_array_equal(got.color_sum[0][chosen],
                                  want.color_sum[0][chosen])


def test_segments_count_live_lanes_only(scene_cam):
    """Segment counts add up over disjoint pixel sets and over targets (the
    counts are integer-valued f32 sums, exact at this size)."""
    def rays(m):
        return float(_accumulate(scene_cam, m.astype(jnp.int32)).rays_traced)

    spp_map = _map([0, 1, 2, SPP], seed=5)
    full = float(_accumulate(scene_cam).rays_traced)
    mask = spp_map > 0
    assert rays(jnp.where(mask, SPP, 0)) + rays(jnp.where(mask, 0, SPP)) == full
    per_target = sum(rays(jnp.where(spp_map == v, v, 0)) for v in (1, 2, SPP))
    assert 0 < rays(spp_map) == per_target < full


def test_render_impl_divides_by_each_pixels_own_count(scene_cam):
    spp_map = _map([1, 2, SPP], seed=6)
    got = np.asarray(_render(scene_cam, spp_map).image).reshape(-1, 3)
    for k in (1, 2, SPP):
        want = np.asarray(_render(scene_cam, spp=k).image).reshape(-1, 3)
        sel = np.asarray(spp_map) == k
        np.testing.assert_array_equal(got[sel], want[sel])
