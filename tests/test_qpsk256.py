"""QPSK256 modem tests (intent of tests/test_qpsk256.cpp)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gsdr_tpu import qpsk256_constellation, qpsk256_demodulate, qpsk256_modulate
from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.qpsk256 import CIRCULAR, RECTANGULAR
from golden import awgn


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(31)


def test_rectangular_geometry():
    # 16x16 grid, I=(i-7.5)/7.5*A, Q=(q-7.5)/7.5*A (src/qpsk256.cu:29-38).
    a = 2.0
    c = np.asarray(qpsk256_constellation(RECTANGULAR, a))
    assert c.shape == (256,)
    assert len(np.unique(np.round(c, 5))) == 256
    idx = 3 * 16 + 10
    np.testing.assert_allclose(c[idx].real, (3 - 7.5) / 7.5 * a, rtol=1e-6)
    np.testing.assert_allclose(c[idx].imag, (10 - 7.5) / 7.5 * a, rtol=1e-6)
    np.testing.assert_allclose(np.max(np.abs(c.real)), a, rtol=1e-6)


def test_circular_geometry():
    # Rings {1,8,16,24,32,40,48,56} at radii {0,.3,.6,.85,1.1,1.35,1.6,1.85}*A,
    # remainder 31 points at 0.95*A (src/qpsk256.cu:41-71).
    a = 1.0
    c = np.asarray(qpsk256_constellation(CIRCULAR, a))
    assert c.shape == (256,)
    assert len(np.unique(np.round(c, 5))) == 256
    np.testing.assert_allclose(np.abs(c[0]), 0.0, atol=1e-7)
    radii = np.abs(c)
    counts = {
        0.3: 8, 0.6: 16, 0.85: 24, 1.1: 32, 1.35: 40, 1.6: 48, 1.85: 56,
        0.95: 31,
    }
    for r, k in counts.items():
        assert np.sum(np.isclose(radii, r * a, atol=1e-5)) == k, f"ring {r}"


@pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
def test_loopback_ser_zero(rng, ctype):
    # tests/test_qpsk256.cpp:105-128: ideal channel, SER == 0.
    c = qpsk256_constellation(ctype, 1.0)
    data = rng.integers(0, 256, size=4096, dtype=np.uint8)
    s = qpsk256_modulate(data, c)
    rec = np.asarray(qpsk256_demodulate(s, c))
    np.testing.assert_array_equal(rec, data)


def test_modulate_is_table_lookup():
    c = qpsk256_constellation(RECTANGULAR, 1.0)
    data = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(qpsk256_modulate(data, c)), np.asarray(c))


@pytest.mark.parametrize("snr_db", [15.0, 20.0, 25.0, 30.0])
def test_ser_under_awgn_rectangular(rng, snr_db):
    # tests/test_qpsk256.cpp:198-240 intent: SER tracks the theoretical-ish
    # bound. For the 16x16 grid (min distance 2A/15, avg power ~0.756 A^2)
    # the per-dimension error rate is ~Q(d/2 / sigma); bounds below are that
    # estimate with ~1.5x margin.
    c = qpsk256_constellation(RECTANGULAR, 1.0)
    data = rng.integers(0, 256, size=1 << 14, dtype=np.uint8)
    s = np.asarray(qpsk256_modulate(data, c))
    noisy = awgn(rng, s, snr_db).astype(np.complex64)
    rec = np.asarray(qpsk256_demodulate(noisy, c))
    ser = np.mean(rec != data)
    bound = {15.0: 0.95, 20.0: 0.60, 25.0: 0.16, 30.0: 0.003}[snr_db]
    assert ser < bound


def test_ser_monotonic_in_snr(rng):
    c = qpsk256_constellation(RECTANGULAR, 1.0)
    data = rng.integers(0, 256, size=1 << 14, dtype=np.uint8)
    s = np.asarray(qpsk256_modulate(data, c))
    sers = []
    for snr_db in [10.0, 20.0, 30.0]:
        noisy = awgn(rng, s, snr_db).astype(np.complex64)
        sers.append(np.mean(np.asarray(qpsk256_demodulate(noisy, c)) != data))
    assert sers[0] > sers[1] > sers[2]


def test_power_characteristics(rng):
    # tests/test_qpsk256.cpp:264-308: average power comparable between
    # geometries; circular has lower peak-to-average ratio than rectangular.
    cr = np.asarray(qpsk256_constellation(RECTANGULAR, 1.0))
    cc = np.asarray(qpsk256_constellation(CIRCULAR, 1.0))
    p_r, p_c = np.mean(np.abs(cr) ** 2), np.mean(np.abs(cc) ** 2)
    assert 0.2 < p_c / p_r < 5.0
    papr_r = np.max(np.abs(cr) ** 2) / p_r
    papr_c = np.max(np.abs(cc) ** 2) / p_c
    assert papr_c < papr_r


def test_multi_stream_channel_axis(rng):
    # The 4x variants (src/qpsk256.cu:104-151,198-259) as a leading axis.
    c = qpsk256_constellation(RECTANGULAR, 1.0)
    data = rng.integers(0, 256, size=(4, 512), dtype=np.uint8)
    s = qpsk256_modulate(data, c)
    rec = np.asarray(qpsk256_demodulate(s, c))
    np.testing.assert_array_equal(rec, data)


def test_tie_breaks_to_lowest_index():
    # Strict < comparison keeps the first best (src/qpsk256.cu:177).
    c = qpsk256_constellation(RECTANGULAR, 1.0)
    cn = np.asarray(c)
    mid = (cn[0] + cn[1]) / 2.0  # equidistant between symbols 0 and 1
    rec = int(np.asarray(qpsk256_demodulate(np.array([mid]), c))[0])
    assert rec == 0


def test_rect_fast_path_matches_exhaustive():
    """qpsk256_demodulate_rect must agree with the exhaustive NN search on
    the rectangular grid (away from exact cell boundaries)."""
    import jax.numpy as jnp
    from gsdr_tpu.carray import ComplexArray
    from gsdr_tpu.ops.qpsk256 import (
        RECTANGULAR, qpsk256_constellation, qpsk256_demodulate,
        qpsk256_demodulate_rect)

    rng = np.random.default_rng(31)
    amp = 1.7
    const = qpsk256_constellation(RECTANGULAR, amp, planar=True)
    # noisy symbols (noise small enough to stay off exact boundaries)
    syms = rng.integers(0, 256, 4096)
    pts = const.to_numpy()[syms]
    noise = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
    rx = pts + 0.03 * amp * noise
    x = ComplexArray.from_complex(rx.astype(np.complex64))
    a = np.asarray(qpsk256_demodulate(x, const, out_dtype=jnp.int32))
    b = np.asarray(qpsk256_demodulate_rect(x, amp, out_dtype=jnp.int32))
    np.testing.assert_array_equal(a, b)


def test_rect_fast_path_ideal_loopback():
    import jax.numpy as jnp
    from gsdr_tpu.ops.qpsk256 import (
        RECTANGULAR, qpsk256_constellation, qpsk256_demodulate_rect,
        qpsk256_modulate)

    rng = np.random.default_rng(32)
    syms = jnp.asarray(rng.integers(0, 256, 2048), jnp.int32)
    const = qpsk256_constellation(RECTANGULAR, 2.5, planar=True)
    tx = qpsk256_modulate(syms, const)
    out = qpsk256_demodulate_rect(tx, 2.5, out_dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(syms))


def test_rect_modulate_fast_path_bit_identical():
    import jax.numpy as jnp
    from gsdr_tpu.ops.qpsk256 import (
        RECTANGULAR, qpsk256_constellation, qpsk256_modulate,
        qpsk256_modulate_rect)

    rng = np.random.default_rng(33)
    syms = jnp.asarray(rng.integers(0, 256, 2048), jnp.int32)
    const = qpsk256_constellation(RECTANGULAR, 1.9, planar=True)
    a = qpsk256_modulate(syms, const)
    b = qpsk256_modulate_rect(syms, 1.9)
    np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), atol=1e-6)


def _golden_nearest(x, const):
    """Exhaustive float64 nearest neighbour, ties to the lowest index."""
    d = np.abs(np.asarray(x)[..., None] - np.asarray(const)[None, :])
    return np.argmin(d, axis=-1)


class TestNearestDemod:
    """The matmul + argmin demodulator against an exhaustive float64
    search."""

    @pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
    def test_bit_identical_on_random(self, ctype):
        const = qpsk256_constellation(ctype, amplitude=2.0)
        rng = np.random.default_rng(99)
        syms = rng.integers(0, 256, 5000)
        noisy = np.asarray(const)[syms] + 0.02 * (
            rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
        ).astype(np.complex64)
        x = ComplexArray.from_complex(noisy.astype(np.complex64))
        got = np.asarray(qpsk256_demodulate(x, const, out_dtype=jnp.int32))
        np.testing.assert_array_equal(got, _golden_nearest(
            noisy.astype(np.complex64), const))

    def test_boundary_inputs_tie_break(self):
        const = qpsk256_constellation(CIRCULAR, amplitude=1.0)
        cnp = np.asarray(const)
        # exact midpoints between random point pairs: both are nearest;
        # the chosen point's distance must be the best distance to f32
        # rounding
        rng = np.random.default_rng(5)
        i = rng.integers(0, 256, 600)
        j = rng.integers(0, 256, 600)
        mids = ((cnp[i] + cnp[j]) / 2).astype(np.complex64)
        x = ComplexArray.from_complex(mids)
        got = np.asarray(qpsk256_demodulate(x, const, out_dtype=jnp.int32))
        want = _golden_nearest(mids, const)
        np.testing.assert_allclose(np.abs(mids - cnp[got]),
                                   np.abs(mids - cnp[want]),
                                   rtol=2e-5, atol=2e-6)

    def test_loopback_exact_all_symbols(self):
        const = qpsk256_constellation(CIRCULAR, amplitude=1.5)
        syms = np.tile(np.arange(256), 5)
        tx = qpsk256_modulate(jnp.asarray(syms), const)
        x = ComplexArray.from_complex(tx)
        got = np.asarray(qpsk256_demodulate(x, const, out_dtype=jnp.int32))
        np.testing.assert_array_equal(got, syms)

    def test_batched_shapes(self):
        const = qpsk256_constellation(RECTANGULAR)
        rng = np.random.default_rng(3)
        syms = rng.integers(0, 256, (4, 333))
        tx = np.asarray(const)[syms]
        x = ComplexArray.from_complex(tx.astype(np.complex64))
        got = np.asarray(qpsk256_demodulate(x, const, out_dtype=jnp.int32))
        assert got.shape == (4, 333)
        np.testing.assert_array_equal(got, syms)

    @pytest.mark.parametrize("impl", ["pallas", "triton"])
    def test_removed_impl_raises(self, impl):
        const = qpsk256_constellation(RECTANGULAR)
        x = ComplexArray.zeros((16,))
        with pytest.raises(ValueError, match="unknown impl"):
            qpsk256_demodulate(x, const, impl=impl)


def test_modulate_gather_returns_table_values():
    """Modulation is the table gather, bit for bit, in both
    representations."""
    for ctype in (0, 1):
        tab = qpsk256_constellation(ctype, planar=True)
        s = jnp.asarray(np.random.default_rng(5).integers(0, 256, 4096),
                        jnp.int32)
        got = qpsk256_modulate(s, tab)
        np.testing.assert_array_equal(np.asarray(got.re),
                                      np.asarray(tab.re)[np.asarray(s)])
        np.testing.assert_array_equal(np.asarray(got.im),
                                      np.asarray(tab.im)[np.asarray(s)])


class TestCircularFastPaths:
    """Round-3 arithmetic circular mod + ring-decomposed NN demod
    (ops/qpsk256.qpsk256_modulate_circular / _demodulate_circular)."""

    def test_modulate_matches_table(self):
        from gsdr_tpu.ops.qpsk256 import qpsk256_modulate_circular

        a = 1.3
        table = np.asarray(qpsk256_constellation(CIRCULAR, a))
        syms = jnp.arange(256, dtype=jnp.int32)
        got = qpsk256_modulate_circular(syms, a)
        got = np.asarray(got.re) + 1j * np.asarray(got.im)
        # f32 sin/cos vs the float64-built table: ~1e-7 relative
        np.testing.assert_allclose(got, table, atol=3e-6 * a)

    def test_demod_matches_exhaustive_on_noise(self, rng):
        from gsdr_tpu.ops.qpsk256 import qpsk256_demodulate_circular

        a = 1.0
        table = qpsk256_constellation(CIRCULAR, a, planar=True)
        n = 1 << 15
        x = ComplexArray(
            jnp.asarray(rng.normal(0, 0.9, n), jnp.float32),
            jnp.asarray(rng.normal(0, 0.9, n), jnp.float32))
        want = np.asarray(qpsk256_demodulate(x, table, out_dtype=jnp.int32,
                                             impl="xla"))
        got = np.asarray(qpsk256_demodulate_circular(x, a,
                                                     out_dtype=jnp.int32))
        agree = np.mean(got == want)
        # identical decisions except samples landing within float rounding
        # of a Voronoi boundary (both answers are nearest there)
        assert agree > 0.9995, agree
        if agree < 1.0:
            # disagreements must be genuine near-ties: distances to the two
            # choices agree to float precision
            c = np.asarray(table.re) + 1j * np.asarray(table.im)
            xz = np.asarray(x.re) + 1j * np.asarray(x.im)
            bad = np.nonzero(got != want)[0]
            d_got = np.abs(xz[bad] - c[got[bad]])
            d_want = np.abs(xz[bad] - c[want[bad]])
            np.testing.assert_allclose(d_got, d_want, rtol=1e-4)

    def test_ideal_loopback_all_symbols(self):
        from gsdr_tpu.ops.qpsk256 import (
            qpsk256_demodulate_circular,
            qpsk256_modulate_circular,
        )

        a = 2.0
        syms = jnp.arange(256, dtype=jnp.int32)
        tx = qpsk256_modulate_circular(syms, a)
        rx = np.asarray(qpsk256_demodulate_circular(tx, a,
                                                    out_dtype=jnp.int32))
        np.testing.assert_array_equal(rx, np.arange(256))

    def test_modem_uses_fast_paths_and_roundtrips(self, rng):
        from gsdr_tpu.pipelines import Qpsk256Modem

        modem = Qpsk256Modem(constellation_type=CIRCULAR, amplitude=1.0)
        syms = jnp.asarray(rng.integers(0, 256, 4096), jnp.int32)
        out = np.asarray(modem.rx(modem.tx(syms)))
        np.testing.assert_array_equal(out, np.asarray(syms))
        # exact_tables=True must behave identically on the ideal channel
        modem_x = Qpsk256Modem(constellation_type=CIRCULAR, amplitude=1.0,
                               exact_tables=True)
        out_x = np.asarray(modem_x.rx(modem_x.tx(syms)))
        np.testing.assert_array_equal(out_x, np.asarray(syms))

    def test_awgn_ser_matches_exhaustive(self, rng):
        from gsdr_tpu.ops.qpsk256 import qpsk256_demodulate_circular

        a = 1.0
        table = qpsk256_constellation(CIRCULAR, a, planar=True)
        syms = rng.integers(0, 256, 1 << 14)
        c = np.asarray(table.re) + 1j * np.asarray(table.im)
        tx = c[syms]
        rx = awgn(rng, tx, 18.0)
        x = ComplexArray(jnp.asarray(rx.real, jnp.float32),
                         jnp.asarray(rx.imag, jnp.float32))
        ser_ring = np.mean(np.asarray(
            qpsk256_demodulate_circular(x, a, out_dtype=jnp.int32)) != syms)
        ser_full = np.mean(np.asarray(
            qpsk256_demodulate(x, table, out_dtype=jnp.int32,
                               impl="xla")) != syms)
        assert abs(ser_ring - ser_full) < 2e-3, (ser_ring, ser_full)
