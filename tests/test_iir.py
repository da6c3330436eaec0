"""IIR tests (intent of tests/test_iir.cpp, plus exactness the reference lacks)."""

import numpy as np
import pytest

from gsdr_tpu import iir, iir_reference, iir_sos
from gsdr_tpu.ops.iir import iir_block
from golden import EDGE_SIZES, iir_golden


def butterworth_lowpass_2nd(fc_norm):
    """2nd-order Butterworth low-pass (bilinear transform), like the in-test
    designs of tests/test_iir.cpp:81-130."""
    c = 1.0 / np.tan(np.pi * fc_norm)
    sq2 = np.sqrt(2.0)
    a0 = c * c + sq2 * c + 1.0
    b = np.array([1.0, 2.0, 1.0]) / a0
    a = np.array([1.0, 2.0 * (1.0 - c * c) / a0, (c * c - sq2 * c + 1.0) / a0])
    return b.astype(np.float32), a.astype(np.float32)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(5)


def test_impulse_response_matches_golden():
    # tests/test_iir.cpp:352-357: first 20 samples of an impulse response.
    b, a = butterworth_lowpass_2nd(0.1)
    x = np.zeros(64, np.float32)
    x[0] = 1.0
    out = np.asarray(iir(b, a, x))
    np.testing.assert_allclose(out[:20], iir_golden(b, a, x)[:20], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_blocked_scan_is_exact_all_sizes(rng, n):
    # The key upgrade over the reference: no state resets at block
    # boundaries (src/iir.cu:118-127 approximates; we are exact).
    b, a = butterworth_lowpass_2nd(0.2)
    x = rng.normal(size=n).astype(np.float32)
    out = np.asarray(iir(b, a, x, block_len=16))
    np.testing.assert_allclose(out, iir_golden(b, a, x), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("block_len", [1, 2, 7, 16, 128, 1024])
def test_block_len_is_performance_knob_only(rng, block_len):
    # samplesPerThread analog (include/gsdr/iir.h:158): any value, same result.
    b, a = butterworth_lowpass_2nd(0.15)
    x = rng.normal(size=777).astype(np.float32)
    out = np.asarray(iir(b, a, x, block_len=block_len))
    np.testing.assert_allclose(out, iir_golden(b, a, x), rtol=1e-3, atol=1e-4)


def test_matches_sequential_reference(rng):
    b, a = butterworth_lowpass_2nd(0.05)
    x = rng.normal(size=2048).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(iir(b, a, x)), np.asarray(iir_reference(b, a, x)),
        rtol=1e-3, atol=1e-4,
    )


def test_complex_input_cc(rng):
    # gsdrIirCC capability.
    b, a = butterworth_lowpass_2nd(0.1)
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    out = np.asarray(iir(b, a, x))
    np.testing.assert_allclose(out, iir_golden(b, a, x), rtol=1e-3, atol=1e-4)


def test_higher_order(rng):
    # 4th-order direct form (coeffCount 5; reference dispatches 2..8,32).
    rng2 = np.random.default_rng(9)
    b = rng2.normal(size=5).astype(np.float32) * 0.1
    a = np.array([1.0, -0.5, 0.2, -0.05, 0.01], np.float32)  # stable
    x = rng.normal(size=1024).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(iir(b, a, x)), iir_golden(b, a, x), rtol=1e-3, atol=1e-4
    )


def test_first_order(rng):
    b = np.array([0.3, 0.0], np.float32)
    a = np.array([1.0, -0.7], np.float32)
    x = rng.normal(size=333).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(iir(b, a, x)), iir_golden(b, a, x), rtol=1e-3, atol=1e-4
    )


def test_frequency_response_passband_stopband(rng):
    # tests/test_iir.cpp:360-402: low frequencies pass, high attenuate.
    b, a = butterworth_lowpass_2nd(0.05)
    n = 1 << 13
    t = np.arange(n)
    lo = np.sin(2 * np.pi * 0.01 * t).astype(np.float32)
    hi = np.sin(2 * np.pi * 0.4 * t).astype(np.float32)
    lo_out = np.asarray(iir(b, a, lo))[n // 4 :]
    hi_out = np.asarray(iir(b, a, hi))[n // 4 :]
    assert np.std(lo_out) > 0.9 * np.std(lo)
    assert np.std(hi_out) < 0.02 * np.std(hi)


def test_streaming_state_continuation(rng):
    # iir_block carries exact state across calls — the working version of
    # the reference's ignored history pointers (include/gsdr/iir.h:74-75).
    b, a = butterworth_lowpass_2nd(0.1)
    x = rng.normal(size=1000).astype(np.float32)
    y_full = np.asarray(iir(b, a, x))
    y1, z = iir_block(b, a, x[:400])
    y2, _ = iir_block(b, a, x[400:], zi=z)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(y1), np.asarray(y2)]), y_full,
        rtol=1e-3, atol=1e-4,
    )


def test_sos_cascade_matches_single_sections(rng):
    b, a = butterworth_lowpass_2nd(0.1)
    sos = np.concatenate([b, a])[None, :]
    x = rng.normal(size=512).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(iir_sos(sos, x)), np.asarray(iir(b, a, x)), rtol=1e-5, atol=1e-6
    )
    # Two cascaded sections == applying them sequentially.
    sos2 = np.stack([np.concatenate([b, a])] * 2)
    expected = iir_golden(b, a, iir_golden(b, a, x))
    np.testing.assert_allclose(np.asarray(iir_sos(sos2, x)), expected, rtol=1e-3, atol=1e-4)


def test_coeff_count_validation():
    x = np.zeros(16, np.float32)
    with pytest.raises(ValueError):
        iir(np.ones(1, np.float32), np.ones(1, np.float32), x)
    with pytest.raises(ValueError):
        iir(np.ones(33, np.float32), np.ones(33, np.float32), x)


def test_batched_channels(rng):
    b, a = butterworth_lowpass_2nd(0.1)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    out = np.asarray(iir(b, a, x))
    for c in range(3):
        np.testing.assert_allclose(out[c], iir_golden(b, a, x[c]), rtol=1e-3, atol=1e-4)


def test_sos_streaming_block_split(rng):
    """Block-split iir_sos_block with carried per-section state equals a
    single-shot cascade (iir_sos takes zi)."""
    from gsdr_tpu.ops.iir import iir_sos_block

    b1, a1 = butterworth_lowpass_2nd(0.1)
    b2, a2 = butterworth_lowpass_2nd(0.3)
    sos = np.stack([np.concatenate([b1, a1]), np.concatenate([b2, a2])])
    x = rng.standard_normal(1000).astype(np.float32)

    full = np.asarray(iir_sos(sos, x))

    zi = None
    outs = []
    for a, b in ((0, 300), (300, 301), (301, 800), (800, 1000)):
        y, zi = iir_sos_block(sos, x[a:b], zi=zi)
        outs.append(np.asarray(y))
    streamed = np.concatenate(outs)
    np.testing.assert_allclose(streamed, full, rtol=1e-4, atol=1e-5)


def test_sos_stream_class(rng):
    from gsdr_tpu.stream import SosStream

    b1, a1 = butterworth_lowpass_2nd(0.15)
    b2, a2 = butterworth_lowpass_2nd(0.25)
    sos = (tuple(np.concatenate([b1, a1]).tolist()),
           tuple(np.concatenate([b2, a2]).tolist()))
    x = rng.standard_normal((3, 512)).astype(np.float32)  # batched channels

    s = SosStream(sos=sos)
    st = s.init(x)
    y1_a = []
    for a, b in ((0, 128), (128, 256), (256, 512)):
        st, y = s.step(st, x[:, a:b])
        y1_a.append(np.asarray(y))
    streamed = np.concatenate(y1_a, axis=-1)
    full = np.asarray(iir_sos(np.asarray(sos, np.float32), x))
    np.testing.assert_allclose(streamed, full, rtol=1e-4, atol=1e-5)
