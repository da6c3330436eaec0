"""Planar (split re/im) path parity with the complex64 path.

The models, kernels and sharded layer run planar float32 / int32
throughout (gsdr_tpu.carray). These tests pin planar == complex for every
op.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gsdr_tpu as g
from gsdr_tpu import ComplexArray
from golden import lowpass_taps


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(77)


def _rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_carray_roundtrip(rng):
    x = _rand_c(rng, 64)
    p = ComplexArray.from_complex(x)
    np.testing.assert_allclose(p.to_numpy(), x, rtol=1e-6)


def test_carray_arithmetic(rng):
    a, b = _rand_c(rng, 32), _rand_c(rng, 32)
    pa, pb = ComplexArray.from_complex(a), ComplexArray.from_complex(b)
    np.testing.assert_allclose((pa * pb).to_numpy(), a * b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((pa + pb).to_numpy(), a + b, rtol=1e-6)
    np.testing.assert_allclose(pa.conj().to_numpy(), np.conj(a), rtol=1e-6)
    np.testing.assert_allclose(pa.abs(), np.abs(a), rtol=1e-5)


def test_freq_shift_planar_matches_complex(rng):
    x = _rand_c(rng, 1024)
    c_out = np.asarray(g.freq_shift(x, -100_000.0, 1_000_000.0, 12345))
    p_out = g.freq_shift(ComplexArray.from_complex(x), -100_000.0, 1_000_000.0, 12345)
    np.testing.assert_allclose(p_out.to_numpy(), c_out, rtol=1e-5, atol=1e-5)


def test_fir_planar_matches_complex(rng):
    x = _rand_c(rng, 512)
    taps = rng.normal(size=31).astype(np.float32)
    c_out = np.asarray(g.fir(x, taps, 4))
    p_out = g.fir(ComplexArray.from_complex(x), taps, 4)
    np.testing.assert_allclose(p_out.to_numpy(), c_out, rtol=1e-5, atol=1e-5)


def test_fir_planar_complex_taps(rng):
    x = _rand_c(rng, 256)
    taps = _rand_c(rng, 16)
    c_out = np.asarray(g.fir(x, taps, 2))
    p_out = g.fir(ComplexArray.from_complex(x), ComplexArray.from_complex(taps), 2)
    np.testing.assert_allclose(p_out.to_numpy(), c_out, rtol=1e-4, atol=1e-5)


def test_quad_demod_planar(rng):
    x = _rand_c(rng, 256)
    np.testing.assert_allclose(
        np.asarray(g.quad_fm_demod(ComplexArray.from_complex(x), 2.0)),
        np.asarray(g.quad_fm_demod(x, 2.0)),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(g.quad_am_demod(ComplexArray.from_complex(x))),
        np.asarray(g.quad_am_demod(x)),
        rtol=1e-5, atol=1e-6,
    )


def test_fm_chain_planar_matches_complex(rng):
    taps = lowpass_taps(33, 0.05)
    n = np.arange(1 << 12)
    x = np.exp(2j * np.pi * (100_000.0 * n / 1e6 + 3 * np.sin(2 * np.pi * 500 * n / 1e6))).astype(np.complex64)
    kw = dict(rf_sample_rate=1e6, tuning_frequency=0.0,
              channel_frequency=100_000.0, frequency_deviation=5_000.0,
              decimation=4)
    c_out = np.asarray(g.fm_demod(x, taps, **kw))
    p_out = np.asarray(g.fm_demod(ComplexArray.from_complex(x), taps, **kw))
    np.testing.assert_allclose(p_out, c_out, rtol=1e-4, atol=1e-4)


def test_am_chain_planar_matches_complex(rng):
    taps = lowpass_taps(33, 0.05)
    x = _rand_c(rng, 4096) * 0.3
    kw = dict(rf_sample_rate=1e6, tuning_frequency=0.0,
              channel_frequency=50_000.0, decimation=2)
    c_out = np.asarray(g.am_demod(x, taps, **kw))
    p_out = np.asarray(g.am_demod(ComplexArray.from_complex(x), taps, **kw))
    np.testing.assert_allclose(p_out, c_out, rtol=1e-4, atol=1e-5)


def test_iir_planar(rng):
    b = np.array([0.2, 0.1, 0.05], np.float32)
    a = np.array([1.0, -0.6, 0.2], np.float32)
    x = _rand_c(rng, 777)
    c_out = np.asarray(g.iir(b, a, x))
    p_out = g.iir(b, a, ComplexArray.from_complex(x))
    np.testing.assert_allclose(p_out.to_numpy(), c_out, rtol=1e-4, atol=1e-5)


def test_qpsk_planar_int32(rng):
    data = rng.integers(0, 256, 256, dtype=np.uint8)
    s = g.qpsk_modulate(data.astype(np.int32), planar=True)
    assert isinstance(s, ComplexArray)
    rec = np.asarray(g.qpsk_demodulate(s, out_dtype=jnp.int32))
    np.testing.assert_array_equal(rec, data.astype(np.int32))


def test_qpsk256_planar_int32(rng):
    c = g.qpsk256_constellation(1, 1.0, planar=True)
    data = rng.integers(0, 256, 1024, dtype=np.int32)
    s = g.qpsk256_modulate(data, c)
    assert isinstance(s, ComplexArray)
    rec = np.asarray(g.qpsk256_demodulate(s, c, out_dtype=jnp.int32))
    np.testing.assert_array_equal(rec, data)


def test_planar_chain_is_jittable(rng):
    """The planar FM chain compiles as one jitted program."""
    taps = lowpass_taps(33, 0.05)

    @jax.jit
    def chain(xp):
        return g.fm_demod(xp, taps, 1e6, 0.0, 100_000.0, 5_000.0, 4)

    x = ComplexArray.from_complex(_rand_c(rng, 4096))
    out = np.asarray(chain(x))
    assert out.shape == ((4096 - 33) // 4 + 1 - 1,)
    assert np.all(np.isfinite(out))
