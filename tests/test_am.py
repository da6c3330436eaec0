"""Fused AM demod chain tests (intent of tests/test_am.cpp; BASELINE config 1)."""

import numpy as np
import pytest

from gsdr_tpu import am_demod
from golden import am_golden, lowpass_taps


FS = 1_000_000.0


def _am_signal(n, fc, fm=1_000.0, depth=0.5, n0=0):
    i = np.arange(n, dtype=np.float64) + n0
    env = 0.5 * (1.0 + depth * np.cos(2 * np.pi * fm * i / FS))
    return (env * np.exp(2j * np.pi * fc * i / FS)).astype(np.complex64)


def test_matches_golden():
    taps = lowpass_taps(33, 0.05)
    x = _am_signal(1 << 12, fc=100_000.0)
    out = np.asarray(
        am_demod(x, taps, FS, tuning_frequency=0.0, channel_frequency=100_000.0,
                 decimation=4)
    )
    expected = am_golden(x, taps, FS, 0.0, 100_000.0, 4)
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, atol=2e-4)


def test_recovers_modulation_tone():
    # Demod a 1 kHz AM tone on a 100 kHz carrier (BASELINE config 1 mirrors
    # test_am.cpp): the demodulated spectrum peaks at the modulation rate.
    taps = lowpass_taps(65, 0.01)
    d = 4
    n = 1 << 16
    x = _am_signal(n, fc=100_000.0, fm=1_000.0, depth=0.8)
    out = np.asarray(am_demod(x, taps, FS, 0.0, 100_000.0, d))
    out = out - out.mean()
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    peak_bin = np.argmax(spec)
    expected_bin = round(1_000.0 * len(out) / (FS / d))
    assert abs(peak_bin - expected_bin) <= 1


def test_phase_continuity_across_blocks():
    # Processing two consecutive blocks with first_sample_index must equal
    # processing the concatenated stream (src/adjustFrequency.cuh:25 contract).
    taps = lowpass_taps(17, 0.05)
    n0, nb = 8192, 4096
    full = _am_signal(n0 + nb, fc=123_000.0)
    out_full = np.asarray(am_demod(full, taps, FS, 0.0, 123_000.0, 1))
    out_blk = np.asarray(
        am_demod(full[n0:], taps, FS, 0.0, 123_000.0, 1, first_sample_index=n0)
    )
    np.testing.assert_allclose(out_blk, out_full[n0:], atol=5e-4)


def test_huge_first_sample_index_is_stable():
    # Exact phase for very large global offsets (beyond f32 integer range).
    taps = lowpass_taps(17, 0.05)
    n0 = 10**12 + 7
    x = _am_signal(4096, fc=100_000.0, n0=n0)
    out = np.asarray(am_demod(x, taps, FS, 0.0, 100_000.0, 1,
                              first_sample_index=n0))
    expected = am_golden(x, taps, FS, 0.0, 100_000.0, 1, first_sample_index=n0)
    np.testing.assert_allclose(out, expected, atol=5e-4)


@pytest.mark.parametrize("n", [65, 128, 1025])
def test_edge_sizes(n):
    taps = lowpass_taps(17, 0.1)
    x = _am_signal(n, fc=50_000.0)
    out = np.asarray(am_demod(x, taps, FS, 0.0, 50_000.0, 2))
    expected = am_golden(x, taps, FS, 0.0, 50_000.0, 2)
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, atol=3e-4)


@pytest.mark.parametrize("impl", ["pallas", "pfb_pallas"])
def test_removed_impl_raises(impl):
    """No kernel serves AM: a kernel impl is an error, not a silent XLA
    run."""
    taps = lowpass_taps(64, 0.05)
    x = _am_signal(512, fc=120_000.0)
    with pytest.raises(ValueError, match="unknown impl"):
        am_demod(x, taps, FS, 0.0, 120_000.0, decimation=4, impl=impl)


def test_auto_equals_xla():
    taps = lowpass_taps(64, 0.05)
    x = _am_signal(5000, fc=120_000.0, n0=777)
    out_x = np.asarray(am_demod(x, taps, FS, 0.0, 120_000.0, decimation=4,
                                first_sample_index=777, impl="xla"))
    out_a = np.asarray(am_demod(x, taps, FS, 0.0, 120_000.0, decimation=4,
                                first_sample_index=777))
    np.testing.assert_array_equal(out_a, out_x)
