"""RNG parity tests: PCG hash bit-exactness and stream/ball statistics."""

import jax.numpy as jnp
import numpy as np

from bevyray_tpu.core import rng


def pcg_scalar(state: int) -> int:
    """Literal uint32 transcription of random.wgsl:8-15 for cross-checking."""
    mask = 0xFFFFFFFF
    old = (state + 747796405 + 2891336453) & mask
    word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & mask
    return ((word >> 22) ^ word) & mask


def test_pcg_step_bit_exact_numpy():
    states = np.array([0, 1, 42, 0xDEADBEEF, 0xFFFFFFFF, 123456789], np.uint32)
    with np.errstate(over="ignore"):
        got = rng.pcg_step(states)
    want = np.array([pcg_scalar(int(s)) for s in states], np.uint32)
    np.testing.assert_array_equal(np.asarray(got, np.uint32), want)


def test_pcg_step_bit_exact_jax():
    states = jnp.array([0, 1, 42, 0xDEADBEEF, 0xFFFFFFFF, 123456789], jnp.uint32)
    got = np.asarray(rng.pcg_step(states))
    want = np.array([pcg_scalar(int(s)) for s in np.asarray(states)], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_float_mapping_range():
    states = jnp.arange(0, 2**32, 2**24, dtype=jnp.uint32)
    f = np.asarray(rng.to_float01(states))
    assert (f >= 0.0).all() and (f < 1.0).all()
    # f32(state) * 2^-32 exactly
    np.testing.assert_allclose(
        f, np.asarray(states).astype(np.float32) / 4294967296.0, rtol=0)


def test_serial_next_float_matches_reference_sequence():
    """Drive the serial API like the WGSL shader would and check the uint32 states."""
    state = np.uint32(1234)
    seq = []
    for _ in range(8):
        with np.errstate(over="ignore"):
            state, f = rng.next_float(state)
        seq.append(int(state))
    # Reference: repeated pcg application
    want, s = [], 1234
    for _ in range(8):
        s = pcg_scalar(s)
        want.append(s)
    assert seq == want


def test_stream_draw_jax_numpy_identical():
    """Oracle (NumPy) and renderer (JAX) must consume identical uniforms."""
    pix = np.arange(100, dtype=np.uint32)
    with np.errstate(over="ignore"):
        s_np = rng.stream_init(pix, np.uint32(3), np.uint32(999))
        d_np = rng.draw(s_np, np.uint32(7))
    s_jx = rng.stream_init(jnp.asarray(pix), jnp.uint32(3), jnp.uint32(999))
    d_jx = np.asarray(rng.draw(s_jx, np.uint32(7)))
    np.testing.assert_array_equal(np.asarray(s_jx, np.uint32), s_np)
    np.testing.assert_array_equal(d_jx, d_np)


def test_uniform_statistics():
    pix = np.arange(200_000, dtype=np.uint32)
    with np.errstate(over="ignore"):
        stream = rng.stream_init(pix, np.uint32(0), np.uint32(1))
        u = rng.draw(stream, np.uint32(0))
    assert abs(u.mean() - 0.5) < 2e-3
    assert abs(u.var() - 1.0 / 12.0) < 1e-3


def test_unit_ball_statistics():
    """Samples must be uniform in the unit ball (same distribution as the
    reference's rejection sampler, random.wgsl:17-26)."""
    n = 100_000
    pix = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        stream = rng.stream_init(pix, np.uint32(0), np.uint32(7))
        us = [rng.draw(stream, np.uint32(k)) for k in range(5)]
    p = rng.unit_ball_from_uniforms_np(*us)
    r = np.linalg.norm(p, axis=-1)
    assert r.max() <= 1.0 + 1e-5
    # E[r] for uniform ball = 3/4; E[components] = 0
    assert abs(r.mean() - 0.75) < 5e-3
    assert np.abs(p.mean(0)).max() < 5e-3
    # CDF of r is r^3: median radius = 0.5^(1/3)
    assert abs(np.median(r) - 0.5 ** (1 / 3)) < 5e-3


def test_unit_ball_jax_matches_numpy():
    n = 1000
    pix = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        stream = rng.stream_init(pix, np.uint32(0), np.uint32(7))
        us_np = [rng.draw(stream, np.uint32(k)) for k in range(5)]
    us_jx = [jnp.asarray(u) for u in us_np]
    p_np = rng.unit_ball_from_uniforms_np(*us_np)
    v = rng.unit_ball_from_uniforms(*us_jx)
    p_jx = np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)
    # XLA and NumPy use different libm implementations for sin/cos/log, so the
    # agreement is ~1e-5 (float32), not bit-exact.
    np.testing.assert_allclose(p_jx, p_np, atol=2e-4)
