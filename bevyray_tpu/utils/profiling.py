"""Profiling & observability — what the reference lacks entirely (SURVEY.md §5:
no GPU timing, ``timestamp_writes: None``; labeled passes only).

Provides named-scope annotation (shows up in XLA/XProf traces), a device trace
context manager, and a frame-timing harness (not yet wired into any benchmark script).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import jax
import numpy as np

named_scope = jax.named_scope  # re-export: annotate ops for trace viewers


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profile (XPlane) to ``log_dir`` for xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class FrameStats:
    times_s: List[float]
    rays_per_frame: float

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.times_s, 50) * 1e3)

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.times_s, 99) * 1e3)

    @property
    def mrays_per_sec(self) -> float:
        p50 = np.percentile(self.times_s, 50)
        return float(self.rays_per_frame / p50 / 1e6)

    def summary(self) -> dict:
        return {"p50_frame_ms": round(self.p50_ms, 2),
                "p99_frame_ms": round(self.p99_ms, 2),
                "mrays_per_sec": round(self.mrays_per_sec, 2),
                "rays_per_frame": int(self.rays_per_frame)}


def time_frames(render_fn: Callable[[int], "jax.Array"], n_frames: int = 8,
                warmup: int = 1, rays_per_frame: Optional[float] = None) -> FrameStats:
    """Time ``render_fn(seed)`` over ``n_frames`` after ``warmup`` calls.

    ``render_fn`` must return something blockable (a FrameResult or array).
    """
    last = None
    for i in range(warmup):
        last = render_fn(i)
        jax.block_until_ready(last)
    if rays_per_frame is None:
        rays_per_frame = float(getattr(last, "rays_traced", 0.0)) if last is not None else 0.0
    times = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        out = render_fn(warmup + i)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return FrameStats(times_s=times, rays_per_frame=rays_per_frame)
