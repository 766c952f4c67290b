"""What keeps the renderer portable across devices: no matrix product in any
step (so no reduced-precision TF32 path can enter on a GPU), no TPU-only
import, and one persistent compile cache per checkout."""

import os
import pathlib

import jax
import jax.numpy as jnp
import pytest

import bevyray_tpu
from bevyray_tpu import RenderConfig, rtiow
from bevyray_tpu.core.vec import Vec3
from bevyray_tpu.engine.film import accumulate_impl, new_film
from bevyray_tpu.engine.renderer import render_impl
from bevyray_tpu.parallel.sharding import make_mesh, make_sharded_step
from bevyray_tpu.utils import compile_cache

CFG = RenderConfig(width=16, height=8, samples_per_pixel=2, bounces=2, level=2)


def _args():
    world = rtiow.final_scene(seed=5, grid=2)
    world.spawn_mesh(*_cube())
    return world.extract(with_bvh=True), world.camera_state(aspect=2.0)


def _cube():
    from bevyray_tpu import StandardMaterial, Transform, cube_mesh
    return (Transform.from_xyz(0.0, 0.5, 1.0), cube_mesh(0.5),
            StandardMaterial(base_color=(0.3, 0.3, 0.3)))


def _jaxprs():
    scene, cam = _args()
    white, far = Vec3.splat(jnp.float32(1.0)), jnp.float32(0.0)
    seed = jnp.uint32(1)

    def render(config):
        return jax.make_jaxpr(lambda s, c: render_impl(
            s, c, config, seed, white, far))(scene, cam)

    yield "render_impl", render(CFG)
    yield "render_impl_bvh", render(RenderConfig(width=16, height=8,
                                                 intersect_backend="bvh"))
    yield "accumulate_impl", jax.make_jaxpr(lambda f, s, c: accumulate_impl(
        f, s, c, CFG, seed, jnp.uint32(0)))(new_film(CFG), scene, cam)
    step = make_sharded_step(make_mesh(2, 2, 2), CFG)
    yield "sharded_step", jax.make_jaxpr(step)(scene, cam, seed, white, far)


def _primitives(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn.primitive.name
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _primitives(sub)


@pytest.mark.parametrize("name", ["render_impl", "render_impl_bvh",
                                  "accumulate_impl", "sharded_step"])
def test_no_matrix_product(name):
    jaxpr = dict(_jaxprs())[name]
    prims = set(_primitives(jaxpr.jaxpr))
    assert "while" in prims          # the walk really is in the jaxpr
    assert not prims & {"dot_general", "conv_general_dilated"}, prims


def test_no_tpu_only_import():
    pkg = pathlib.Path(bevyray_tpu.__file__).parent
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "pallas.tpu" not in text and "pallas_call" not in text, path


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        root = pathlib.Path(bevyray_tpu.__file__).parent.parent
        assert path == os.path.join(str(root), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
