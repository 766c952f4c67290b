"""``resolve_intersect_backend``: the choice depends on the scene alone (no
platform in play), and the dense scene generator sits above the crossover."""

import numpy as np
import pytest

from bevyray_tpu import RenderConfig, rtiow
from bevyray_tpu.bvh import build_scene_bvh
from bevyray_tpu.core.types import (SceneBuffers, make_materials_np,
                                    make_spheres_np, make_triangles_np)
from bevyray_tpu.engine.renderer import (BVH_CROSSOVER, make_intersect_fn,
                                         resolve_intersect_backend)


def _scene(sphere_cap, with_bvh=False, tri_cap=None, tri_bvh=False):
    one = np.zeros((1, 3), np.float32)
    spheres = make_spheres_np(one, np.ones(1), np.zeros(1),
                              capacity=sphere_cap)
    a_bvh = build_scene_bvh(one, np.ones(1, np.float32))
    bvh = a_bvh if with_bvh else None
    tris = (make_triangles_np(one, one + [1, 0, 0], one + [0, 1, 0],
                              np.zeros(1), capacity=tri_cap)
            if tri_cap else None)
    tbvh = a_bvh if tri_bvh else None   # any BVH: only its presence counts
    return SceneBuffers(spheres=spheres, materials=make_materials_np(
        np.zeros((1, 11), np.float32)), bvh=bvh, triangles=tris, tri_bvh=tbvh)


def _cfg(backend="auto"):
    return RenderConfig(width=8, height=8, intersect_backend=backend)


@pytest.mark.parametrize("cap,with_bvh,want", [
    (128, True, "brute"),                     # small table, BVH present
    (BVH_CROSSOVER, True, "brute"),           # at the crossover: still brute
    (BVH_CROSSOVER + 128, True, "bvh"),       # above it, with a BVH
    (BVH_CROSSOVER + 128, False, "brute"),    # above it, no BVH to walk
])
def test_auto_by_sphere_capacity(cap, with_bvh, want):
    assert resolve_intersect_backend(_scene(cap, with_bvh), _cfg()) == want


def test_auto_counts_triangles():
    """A triangle-heavy scene walks its BVH even with a small sphere table."""
    scene = _scene(128, tri_cap=BVH_CROSSOVER + 128, tri_bvh=True)
    assert resolve_intersect_backend(scene, _cfg()) == "bvh"


@pytest.mark.parametrize("backend", ["brute", "bvh"])
def test_explicit_choice_wins(backend):
    assert resolve_intersect_backend(_scene(BVH_CROSSOVER + 128, True),
                                     _cfg(backend)) == backend
    assert resolve_intersect_backend(_scene(128, True), _cfg(backend)) == backend


def test_bvh_requested_without_bvh_raises():
    with pytest.raises(ValueError, match="no BVH"):
        make_intersect_fn(_scene(128, with_bvh=False), _cfg("bvh"))


def test_dense_scene_is_deterministic_and_above_crossover():
    a, b = rtiow.dense_scene(n=600, seed=3), rtiow.dense_scene(n=600, seed=3)
    ca, ra, ma, _ = a.extract_host()
    cb, rb, mb, _ = b.extract_host()
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(ma, mb)
    assert not np.array_equal(ca, rtiow.dense_scene(n=600, seed=4)
                              .extract_host()[0])
    dense = rtiow.dense_scene()
    assert dense.n_spheres == 5001
    assert resolve_intersect_backend(dense.extract(), _cfg()) == "bvh"
