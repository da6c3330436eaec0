"""Wideband TX -> AWGN channel -> RX duplex loopback.

End-to-end composition of the PFB SYNTHESIS bank (transmit combiner,
ops/pfb.pfb_synthesize) against the uniform-grid FM channelizer: K FM
channels synthesized into one wideband stream, AWGN added at a controlled
SNR, then channelized + demodulated; every channel's audio must carry the
transmitted tone at a bounded SNR. This is the analysis bank and the
synthesis bank certifying each other — the reference has no channel
combiner at all, and its AWGN-at-SNR recovery intent lives in
/root/reference/tests/test_qpsk256.cpp:198-240.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from examples.wideband_duplex import run_duplex  # noqa: E402


@pytest.mark.parametrize("impl", ["xla", "pfb"])
def test_duplex_loopback_recovers_all_channels(impl):
    fs = 1_024_000.0
    k = 8
    tones, audio, snrs, peaks_ok = run_duplex(
        fs, k, m_frames=2048, impl=impl, snr_db=30.0)
    assert audio.shape == (k, 2048)
    assert all(peaks_ok), f"tone peaks missed: {peaks_ok}"
    # audio SNR bound: 30 dB channel SNR -> comfortably > 15 dB audio
    # (FM processing gain vs filter-transition leakage; measured ~20+ dB)
    assert snrs.min() > 15.0, f"audio SNRs {snrs}"


def test_streaming_duplex_blocks_match_one_shot():
    """The full duplex run in BLOCKS — pfb_synthesize_block with carried
    tails feeding the streaming FmChannelizer with carried state — must
    reproduce the one-shot pipeline exactly (TX side) and continue the
    RX stream seamlessly (the reference's caller-managed overlap
    contracts, replaced by framework state, composed across both
    banks)."""
    import jax.numpy as jnp

    from gsdr_tpu.carray import ComplexArray
    from gsdr_tpu.ops.pfb import pfb_synthesize_block
    from gsdr_tpu.pipelines import FmChannelizer
    from examples.wideband_duplex import lowpass

    fs, k, q = 1_024_000.0, 8, 8
    m = 1024
    rng = np.random.default_rng(4)
    fs_ch = fs / k
    dev = 0.25 * fs_ch / 2.0
    basebands = np.zeros((k, m), np.complex128)
    for c in range(k):
        msg = np.sin(2 * np.pi * (300.0 + 83.0 * c)
                     * np.arange(m) / fs_ch)
        basebands[c] = (1.0 / k) * np.exp(
            1j * (2 * np.pi * (dev / fs_ch) * np.cumsum(msg)))
    chans = ComplexArray(np.asarray(basebands.real, np.float32),
                         np.asarray(basebands.imag, np.float32))
    syn_taps = lowpass(q * k, 0.4 / k)

    # TX: block-split synthesis == one-shot (bit-exact)
    want, _ = pfb_synthesize_block(chans, syn_taps, k)
    o1, tail = pfb_synthesize_block(chans[..., :m // 2], syn_taps, k)
    o2, _ = pfb_synthesize_block(chans[..., m // 2:], syn_taps, k,
                                 tail=tail)
    got = np.concatenate([np.asarray(o1.re), np.asarray(o2.re)])
    np.testing.assert_array_equal(got, np.asarray(want.re))

    # RX: streamed blocks == one big block (state continuation)
    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=tuple(
            c * fs / k if c < k / 2 else c * fs / k - fs
            for c in range(k)),
        frequency_deviation=dev, decimation=k,
        low_pass_taps=tuple(lowpass(q * k, 0.4 / k)), impl="pfb")
    wide = want
    st = model.init()
    _, audio_one = model.step(st, wide)
    st2 = model.init()
    outs = []
    nb = wide.shape[-1] // 4
    for i in range(4):
        st2, a = model.step(st2, wide[..., i * nb:(i + 1) * nb])
        outs.append(np.asarray(a))
    audio_blocks = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(audio_blocks, np.asarray(audio_one),
                               atol=5e-4)


def test_qpsk_transmux_error_free_at_25db():
    """Channelized QPSK digital link (round 5): K QPSK streams through
    synthesize -> AWGN -> channelize with a one-tap pilot equalizer must
    be symbol-error-free at 25 dB (the reference's QPSK BER intent,
    /root/reference/tests/test_qpsk.cpp:172-210, composed through the
    beyond-parity channel banks)."""
    from examples.qpsk_transmux import run_transmux

    sers, evms, tot = run_transmux(16, 2048, snr_db=25.0)
    assert tot > 30_000
    assert sers.max() == 0.0, sers
    # ~0.24 EVM = the critical cascade's structural full-rate ISI (the
    # Nyquist packing bound) — well inside QPSK's 0.707
    # decision margin, hence error-free
    assert evms.max() < 0.3, evms


def test_qpsk_transmux_degrades_with_noise():
    from examples.qpsk_transmux import run_transmux

    _, evm_hi, _ = run_transmux(8, 1024, snr_db=30.0, seed=2)
    _, evm_lo, _ = run_transmux(8, 1024, snr_db=5.0, seed=2)
    assert evm_lo.mean() > evm_hi.mean()


def test_duplex_noise_floor_scales_with_channel_snr():
    """Monotonicity (the reference's BER-vs-SNR pattern applied to the
    duplex): more channel noise must not IMPROVE recovered audio."""
    fs = 1_024_000.0
    k = 8
    _, _, snr_hi, _ = run_duplex(fs, k, m_frames=1536, impl="xla",
                                 snr_db=35.0, seed=3)
    _, _, snr_lo, _ = run_duplex(fs, k, m_frames=1536, impl="xla",
                                 snr_db=10.0, seed=3)
    assert snr_lo.mean() < snr_hi.mean()
