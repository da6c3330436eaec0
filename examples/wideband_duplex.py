"""Example: wideband TX -> channel -> RX duplex loopback (round 5).

The transmit side synthesizes K per-channel FM basebands into ONE wideband
stream with the PFB SYNTHESIS bank (gsdr_tpu.ops.pfb.pfb_synthesize — the
IDFT + polyphase interpolation combiner, a capability beyond the reference,
which ships per-stream modulators but no channel combiner). The stream
passes through an AWGN channel, and the receive side runs the streaming
FmChannelizer on the uniform grid (critical decimation, Q = 8): impl='auto'
runs the dense front, impl='pfb' (--pfb) the polyphase front. Per-channel audio is verified two ways: the dominant
tone lands at the transmitted message frequency, and the least-squares
audio SNR against the known tone clears a bound.

Reference test intent: AWGN-at-controlled-SNR recovery patterns,
/root/reference/tests/test_qpsk256.cpp:198-240.

Run from the repo root:

    python examples/wideband_duplex.py [--cpu] [--pfb]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:  # force CPU before any backend init
    import jax as _jax
    _jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.pfb import pfb_synthesize
from gsdr_tpu.pipelines import FmChannelizer


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float64)


def run_duplex(fs, k, m_frames, impl, snr_db=30.0, q_syn=8, q_rx=8,
               seed=0):
    """Synthesize K FM channels -> wideband -> AWGN -> channelize+demod.

    Returns (tones, audio, per-channel audio SNR dB, peak-ok bools).
    """
    fs_ch = fs / k
    deviation = 0.25 * fs_ch / 2.0   # modest index: spectrum well inside
    tones = tuple(300.0 + 83.0 * c for c in range(k))
    rng = np.random.default_rng(seed)

    # --- TX: per-channel FM baseband at the channel rate ----------------
    mm = np.arange(m_frames) / fs_ch
    basebands = np.zeros((k, m_frames), np.complex128)
    for c, tone in enumerate(tones):
        msg = np.sin(2 * np.pi * tone * mm + rng.uniform(0, 6))
        phase = 2 * np.pi * (deviation / fs_ch) * np.cumsum(msg)
        basebands[c] = (1.0 / k) * np.exp(1j * phase)
    chans = ComplexArray(
        np.asarray(basebands.real, np.float32),
        np.asarray(basebands.imag, np.float32))
    syn_taps = lowpass(q_syn * k, 0.4 / k)
    wide = pfb_synthesize(chans, syn_taps, k)      # (M*K,) at Fs

    # --- channel: AWGN at snr_db vs the wideband signal power -----------
    wide_np = wide.to_numpy()
    p_sig = float(np.mean(np.abs(wide_np) ** 2))
    sigma = np.sqrt(p_sig / (10.0 ** (snr_db / 10.0)) / 2.0)
    noisy = wide_np + sigma * (
        rng.standard_normal(wide_np.shape)
        + 1j * rng.standard_normal(wide_np.shape))
    rf = ComplexArray(np.asarray(noisy.real, np.float32),
                      np.asarray(noisy.imag, np.float32))

    # --- RX: uniform-grid FM channelizer -------------------------------
    channels = tuple(
        c * fs / k if c < k / 2 else c * fs / k - fs for c in range(k))
    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=channels, frequency_deviation=deviation,
        decimation=k, low_pass_taps=tuple(lowpass(q_rx * k, 0.4 / k)),
        impl=impl)
    state = model.init()
    _, audio = jax.jit(model.step)(state, rf)
    audio = np.asarray(audio)                       # (K, M) at fs_ch

    # --- verify: FFT peak at the tone + least-squares audio SNR ---------
    arate = fs_ch
    skip = max(q_syn, q_rx) * 2 + 256   # filter transients + deemph settle
    snrs, peaks_ok = [], []
    for c, tone in enumerate(tones):
        a = audio[c, skip:] - np.mean(audio[c, skip:])
        idx = np.arange(len(a)) / arate
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = np.argmax(spec) * arate / len(a)
        peaks_ok.append(bool(abs(peak - tone) < 2 * arate / len(a)))
        basis = np.stack([np.sin(2 * np.pi * tone * idx),
                          np.cos(2 * np.pi * tone * idx)], axis=1)
        coef, *_ = np.linalg.lstsq(basis, a, rcond=None)
        fit = basis @ coef
        resid = a - fit
        snrs.append(10.0 * np.log10(
            np.sum(fit ** 2) / max(np.sum(resid ** 2), 1e-30)))
    return tones, audio, np.asarray(snrs), peaks_ok


def main():
    fs = 2_048_000.0
    k = 32
    impl = "pfb" if "--pfb" in sys.argv else "auto"
    tones, audio, snrs, peaks_ok = run_duplex(
        fs, k, m_frames=8192, impl=impl, snr_db=30.0)
    print(f"audio: {audio.shape} at {fs / k:.0f} Hz/channel (impl={impl})")
    ok = True
    for c, tone in enumerate(tones):
        good = peaks_ok[c] and snrs[c] > 15.0
        ok &= good
        if c % 8 == 0 or not good:
            print(f"  ch {c:2d}: tone {tone:7.1f} Hz "
                  f"{'found' if peaks_ok[c] else 'MISSED'}, "
                  f"audio SNR {snrs[c]:5.1f} dB "
                  f"{'ok' if good else 'FAIL'}")
    print(f"duplex loopback: {'all channels recovered' if ok else 'FAILED'}"
          f" (min SNR {snrs.min():.1f} dB)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
