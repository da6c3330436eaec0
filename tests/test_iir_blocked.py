"""The blocked IIR (ops/iir.py): matmul zero-state pass, cross-block scan,
streaming state — against the exact sequential recurrence.

The filter set covers first to fourth order, real and complex, distinct
and repeated poles.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.iir import iir_block, iir_reference

RNG = np.random.default_rng(23)


def butter2(fc):
    c = 1.0 / np.tan(np.pi * fc)
    sq2 = np.sqrt(2.0)
    a0 = c * c + sq2 * c + 1.0
    b = np.array([1.0, 2.0, 1.0]) / a0
    a = np.array([1.0, 2.0 * (1.0 - c * c) / a0, (c * c - sq2 * c + 1.0) / a0])
    return b, a


def deemph(tau=75e-6, fs=250e3):
    k = np.tan(1.0 / (2.0 * tau * fs))
    b0 = k / (1.0 + k)
    return np.array([b0, b0]), np.array([1.0, (k - 1.0) / (k + 1.0)])


FILTERS = {
    "first_order_deemph": deemph(),
    "biquad_complex_poles": butter2(0.1),
    "biquad_wide": butter2(0.35),
    # two distinct real poles
    "real_poles": (np.array([1.0, 0.3, 0.02]),
                   np.poly(np.array([0.5, -0.3]))),
    # 4th order: two complex pairs (cascade product expanded)
    "fourth_order": (
        np.convolve(butter2(0.08)[0], butter2(0.22)[0]),
        np.convolve(butter2(0.08)[1], butter2(0.22)[1]),
    ),
    # odd order: one real pole + complex pair
    "third_order": (
        np.convolve(deemph()[0], butter2(0.15)[0]),
        np.convolve(deemph()[1], butter2(0.15)[1]),
    ),
}


def _f32(name):
    b, a = FILTERS[name]
    return b.astype(np.float32), a.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_matches_exact_scan(name):
    bf, af = _f32(name)
    x = RNG.standard_normal(5000).astype(np.float32)
    want = iir_reference(bf, af, x)
    got, _ = iir_block(bf, af, x, block_len=256)
    assert _rel(got, want) < 2e-4, name


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 2048, 5000])
def test_edge_sizes(n):
    bf, af = _f32("biquad_complex_poles")
    x = RNG.standard_normal(n).astype(np.float32)
    got, _ = iir_block(bf, af, x, block_len=256)
    assert _rel(got, iir_reference(bf, af, x)) < 2e-4


def test_state_handoff_three_blocks():
    """zi/final-state are TDF-II vectors: three streamed blocks of unequal
    length equal the single shot."""
    bf, af = _f32("biquad_complex_poles")
    x = RNG.standard_normal(3000).astype(np.float32)
    full = iir_reference(bf, af, x)
    y1, z1 = iir_block(bf, af, x[:1000])
    y2, z2 = iir_block(bf, af, x[1000:2000], zi=z1, block_len=64)
    y3, _ = iir_block(bf, af, x[2000:], zi=z2)
    streamed = np.concatenate([np.asarray(y) for y in (y1, y2, y3)])
    assert _rel(streamed, full) < 5e-4


def test_first_order_state_handoff():
    bf, af = _f32("first_order_deemph")
    x = RNG.standard_normal(4096).astype(np.float32)
    full, zf_full = iir_block(bf, af, x)
    y1, z1 = iir_block(bf, af, x[:2048])
    y2, z2 = iir_block(bf, af, x[2048:], zi=z1)
    streamed = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert _rel(streamed, full) < 2e-4
    np.testing.assert_allclose(np.asarray(z2), np.asarray(zf_full),
                               rtol=2e-3, atol=1e-5)


def test_repeated_poles():
    """A double real pole (defective state matrix) needs no special case."""
    a = np.poly([0.5, 0.5]).astype(np.float32)
    b = np.array([1.0, 0.0, 0.0], np.float32)
    x = RNG.standard_normal(3000).astype(np.float32)
    got, _ = iir_block(b, a, x)
    assert _rel(got, iir_reference(b, a, x)) < 2e-4


def test_eighth_order():
    """Order 8 (four biquads expanded): the host tables are built by
    sequential products, the well-conditioned order for a companion
    matrix."""
    b, a = np.ones(1), np.ones(1)
    for fc in (0.05, 0.1, 0.2, 0.3):
        b = np.convolve(b, butter2(fc)[0])
        a = np.convolve(a, butter2(fc)[1])
    x = RNG.standard_normal(2000).astype(np.float32)
    got, _ = iir_block(b.astype(np.float32), a.astype(np.float32), x)
    want = iir_reference(b.astype(np.float32), a.astype(np.float32), x)
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("impl", ["pallas", "triton"])
def test_removed_impl_raises(impl):
    bf, af = _f32("biquad_complex_poles")
    with pytest.raises(ValueError, match="unknown impl"):
        iir_block(bf, af, np.zeros(16, np.float32), impl=impl)


def test_auto_is_xla():
    bf, af = _f32("biquad_complex_poles")
    x = RNG.standard_normal(1024).astype(np.float32)
    y_auto, _ = iir_block(bf, af, x)
    y_xla, _ = iir_block(bf, af, x, impl="xla")
    np.testing.assert_array_equal(np.asarray(y_auto), np.asarray(y_xla))


def test_planar_complex_input():
    bf, af = _f32("biquad_complex_poles")
    z = (RNG.standard_normal(2000) + 1j * RNG.standard_normal(2000))
    x = ComplexArray.from_complex(z.astype(np.complex64))
    got, _ = iir_block(bf, af, x)
    want_re = iir_reference(bf, af, z.real.astype(np.float32))
    want_im = iir_reference(bf, af, z.imag.astype(np.float32))
    assert _rel(got.re, want_re) < 2e-4
    assert _rel(got.im, want_im) < 2e-4


def test_traced_coefficients_match_host_tables():
    """Coefficients traced under jit take the on-device table build; they
    agree with the host-built tables."""
    bf, af = _f32("third_order")
    x = RNG.standard_normal((2, 1500)).astype(np.float32)
    host, zh = iir_block(bf, af, x, block_len=128)
    traced, zt = jax.jit(lambda b, a: iir_block(b, a, x, block_len=128))(
        jnp.asarray(bf), jnp.asarray(af))
    assert _rel(traced, host) < 1e-5
    np.testing.assert_allclose(np.asarray(zt), np.asarray(zh), atol=1e-5)


@pytest.mark.parametrize("block_len", [1, 7, 64, 256])
def test_block_len_is_inert(block_len):
    bf, af = _f32("fourth_order")
    x = RNG.standard_normal(1000).astype(np.float32)
    zi = np.full(4, 0.1, np.float32)
    got, zf = iir_block(bf, af, x, zi=zi, block_len=block_len)
    want, zf_want = iir_block(bf, af, x, zi=zi, block_len=1000)
    assert _rel(got, want) < 1e-5
    np.testing.assert_allclose(np.asarray(zf), np.asarray(zf_want),
                               atol=1e-5)
