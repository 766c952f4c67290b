"""The XLA renderer against the NumPy oracle over scene × level × intersect
backend, plus frame sizes that are no multiple of anything and the full
508-sphere final scene. Limits are the golden ones (``testing.parity``)."""

import pytest

from bevyray_tpu import rtiow
from bevyray_tpu.testing.parity import (GLASS_METAL, MATRIX_SCENES, GoldenCase,
                                        run_case)

LEVELS = (1, 2, 3)
BACKENDS = ("brute", "bvh")


def _case(scene, level, width=40, height=32, spp=2, seed=3):
    tol = {} if scene == "simple" else GLASS_METAL
    return GoldenCase(f"{scene}-L{level}", MATRIX_SCENES[scene], width, height,
                      spp, 4, level, seed,
                      defocus=(scene == "defocus-emissive"), **tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("scene", sorted(MATRIX_SCENES))
def test_matches_oracle(scene, level, backend):
    run_case(_case(scene, level), intersect_backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("size", [(37, 23), (50, 17)])
def test_nonaligned_resolution_matches_oracle(size, backend):
    run_case(_case("final-grid2", 2, *size, seed=8), intersect_backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_final_scene_matches_oracle(backend):
    """All 508 spheres of ``final_scene(seed=42)`` (the headline scene), with
    its raster cube, at a small size."""
    world = rtiow.final_scene(seed=42)
    case = GoldenCase("final-full", lambda: world, 32, 18, 2, 4, 2, 5,
                      **GLASS_METAL)
    run_case(case, intersect_backend=backend, world=world)
