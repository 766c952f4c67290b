"""The accelerator a measurement runs on: a GPU or nothing.

``bench.py`` and ``chip_smoke.py`` time and check the card. A run that finds no GPU
stops here; it never falls back to the CPU, whose numbers would be read as the
card's.
"""

from __future__ import annotations

import subprocess
from typing import List

import jax


def require_gpus(count: int = 1) -> List[jax.Device]:
    """The first ``count`` GPUs, or SystemExit (non-zero) when there are fewer."""
    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no accelerator: {e}") from e
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < count or devices[0].platform != "gpu":
        raise SystemExit(
            f"needs {count} GPU(s); JAX found {[str(d) for d in devices]}")
    return gpus[:count]


def card_lines() -> List[str]:
    """Name and power limit of each card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_record(devices) -> dict:
    """Platform, kind and count of a run's devices, as JAX reports them."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
