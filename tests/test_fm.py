"""Fused FM demod chain tests (intent of tests/test_fm.cpp; BASELINE config 3)."""

import numpy as np
import pytest

from gsdr_tpu import fm_demod, fm_demod_gain
from golden import fm_golden, lowpass_taps

FS = 1_000_000.0


def _fm_signal(n, fc, f_mod, deviation, n0=0):
    """Complex FM: carrier fc, sinusoidal modulation, given deviation."""
    i = np.arange(n, dtype=np.float64) + n0
    phase = (
        2 * np.pi * fc * i / FS
        + (deviation / f_mod) * np.sin(2 * np.pi * f_mod * i / FS)
    )
    return np.exp(1j * phase).astype(np.complex64)


def test_gain_formula():
    # gain = Fs / (2*pi*deviation), src/fm.cu:203.
    np.testing.assert_allclose(
        fm_demod_gain(1e6, 75e3), 1e6 / (2 * np.pi * 75e3), rtol=1e-12
    )


def test_matches_golden():
    taps = lowpass_taps(33, 0.05)
    x = _fm_signal(1 << 12, fc=100_000.0, f_mod=1_000.0, deviation=5_000.0)
    out = np.asarray(
        fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, decimation=4)
    )
    expected = fm_golden(x, taps, FS, 0.0, 100_000.0, 5_000.0, 4)
    assert out.shape == expected.shape
    np.testing.assert_allclose(out, expected, atol=2e-3)


def test_recovers_modulating_tone():
    # Variance-under-modulation intent of tests/test_fm.cpp:114-143: the
    # demodulated signal is the modulating sinusoid (scaled ~1 for
    # deviation-matched gain).
    taps = lowpass_taps(65, 0.02)
    d = 4
    x = _fm_signal(1 << 16, fc=100_000.0, f_mod=400.0, deviation=10_000.0)
    out = np.asarray(fm_demod(x, taps, FS, 0.0, 100_000.0, 10_000.0, d))
    out = out[256:-256]  # trim filter transients
    # Modulating tone: cos(2*pi*f_mod*t). With the reference's gain
    # convention gain = Fs_rf/(2*pi*dev) (src/fm.cu:203) while the
    # discriminator runs at the decimated rate, the recovered amplitude is
    # scaled by the decimation factor d.
    assert np.std(out) == pytest.approx(d / np.sqrt(2), rel=0.05)
    spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
    expected_bin = round(400.0 * len(out) / (FS / d))
    assert abs(np.argmax(spec) - expected_bin) <= 1


def test_constant_carrier_near_zero_output():
    # Demodulating an unmodulated carrier at the channel center gives ~0.
    taps = lowpass_taps(33, 0.05)
    i = np.arange(1 << 12)
    x = np.exp(2j * np.pi * 150_000.0 * i / FS).astype(np.complex64)
    out = np.asarray(fm_demod(x, taps, FS, 0.0, 150_000.0, 75_000.0, 4))
    assert np.max(np.abs(out[8:])) < 1e-2


def test_output_length_one_less_than_filtered():
    taps = lowpass_taps(16, 0.1)
    n, d = 1024, 4
    x = _fm_signal(n, 0.0, 100.0, 1000.0)
    out = np.asarray(fm_demod(x, taps, FS, 0.0, 0.0, 1000.0, d))
    n_filtered = (n - 16) // d + 1
    assert out.shape == (n_filtered - 1,)


def test_phase_continuity_across_blocks():
    taps = lowpass_taps(33, 0.05)
    n0, nb = 4096, 4096
    full = _fm_signal(n0 + nb, fc=100_000.0, f_mod=500.0, deviation=5_000.0)
    out_full = np.asarray(fm_demod(full, taps, FS, 0.0, 100_000.0, 5_000.0, 1))
    out_blk = np.asarray(
        fm_demod(full[n0:], taps, FS, 0.0, 100_000.0, 5_000.0, 1,
                 first_sample_index=n0)
    )
    np.testing.assert_allclose(out_blk, out_full[n0:], atol=5e-3)


def test_multi_channel_batch():
    # The k_Fm4x direction (src/fm.cu:71-179, dead in the reference) done
    # properly: a channel axis.
    taps = lowpass_taps(33, 0.05)
    chans = [100_000.0, 200_000.0]
    n = 1 << 12
    sigs = np.stack([_fm_signal(n, fc, 1_000.0, 5_000.0) for fc in chans])
    mixed = sigs.sum(axis=0).astype(np.complex64)
    outs = []
    for fc in chans:
        outs.append(np.asarray(fm_demod(mixed, taps, FS, 0.0, fc, 5_000.0, 4)))
    ref0 = fm_golden(mixed, taps, FS, 0.0, chans[0], 5_000.0, 4)
    np.testing.assert_allclose(outs[0], ref0, atol=2e-2)


@pytest.mark.parametrize("impl", ["pallas", "pfb_pallas"])
def test_removed_impl_raises(impl):
    """No kernel serves the one-channel op: a kernel impl is an error,
    not a silent XLA run (the fused kernel serves FmChannelizer)."""
    taps = lowpass_taps(64, 0.03)
    x = _fm_signal(512, fc=100_000.0, f_mod=1_500.0, deviation=5_000.0)
    with pytest.raises(ValueError, match="unknown impl"):
        fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0, decimation=4,
                 impl=impl)


def test_auto_equals_xla():
    taps = lowpass_taps(64, 0.03)
    x = _fm_signal(5000, fc=100_000.0, f_mod=1_500.0, deviation=5_000.0,
                   n0=12_345)
    out_x = np.asarray(fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0,
                                decimation=4, first_sample_index=12_345,
                                impl="xla"))
    out_a = np.asarray(fm_demod(x, taps, FS, 0.0, 100_000.0, 5_000.0,
                                decimation=4, first_sample_index=12_345))
    np.testing.assert_array_equal(out_a, out_x)
