"""Test harness config: the CPU platform with an 8-device virtual mesh.

The suite runs on the CPU only (``JAX_PLATFORMS=cpu``); the platform is also pinned
through ``jax.config`` *before any backend is instantiated*, so a machine with a GPU
still runs the tests on its CPU. The on-card checks live in ``chip_smoke.py``.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
