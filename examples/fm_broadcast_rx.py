"""Example: 3-station FM broadcast receiver from a synthetic IQ capture.

Synthesizes a wideband capture with three FM stations, runs the streaming
FmChannelizer (the fused kernel on a GPU, the XLA chain elsewhere), and
reports the recovered audio tones. Run from the repo root:

    python examples/fm_broadcast_rx.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:  # force CPU before any backend init
    import jax as _jax
    _jax.config.update("jax_platforms", "cpu")

import tempfile

import numpy as np
import jax

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.pipelines import FmChannelizer
from gsdr_tpu.utils.checkpoint import save_state


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def main():
    fs = 2_000_000.0
    stations = (-400_000.0, 0.0, 500_000.0)   # baseband offsets
    tones = (440.0, 1000.0, 2500.0)
    deviation = 75_000.0
    n = 1 << 18

    # synthesize the capture
    t = np.arange(n) / fs
    rf = np.zeros(n, np.complex128)
    for f0, tone in zip(stations, tones):
        msg = np.sin(2 * np.pi * tone * t)
        phase = 2 * np.pi * f0 * t + (deviation / tone) * (1 - np.cos(
            2 * np.pi * tone * t))
        rf += 0.3 * np.exp(1j * phase)
    rf = ComplexArray.from_complex(rf.astype(np.complex64))

    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=stations, frequency_deviation=deviation,
        decimation=8, low_pass_taps=lowpass(128, 0.05),
        impl="auto",  # fused kernel on a GPU, XLA chain elsewhere
    )
    step = jax.jit(model.step)
    state = model.init()
    block = 1 << 16
    audio_blocks = []
    for i in range(n // block):
        state, audio = step(state, rf[..., i * block:(i + 1) * block])
        audio_blocks.append(np.asarray(audio))
    audio = np.concatenate(audio_blocks, axis=-1)

    arate = fs / model.decimation
    for c, want in enumerate(tones):
        a = audio[c][500:] - audio[c][500:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = (np.argmax(spec[5:]) + 5) * arate / len(a)
        print(f"station {c} @ {stations[c]/1e3:+.0f} kHz: "
              f"tone {peak:.1f} Hz (expected {want})")

    path = os.path.join(tempfile.gettempdir(), "fm_rx_state.npz")
    save_state(path, state)
    print(f"stream state checkpointed to {path}")


if __name__ == "__main__":
    main()
