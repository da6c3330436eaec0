"""Example: 32-channel wideband uniform-grid FM receiver (PFB front).

Synthesizes a capture with FM carriers on every channel of a uniform
Fs/32 grid, runs the streaming FmChannelizer (impl='auto', or the PFB
front with --pfb: the fold + DFT shares the long prototype filter across
the grid), and verifies
every channel's recovered audio tone. Run from the repo root:

    python examples/wideband_rx.py [--cpu]
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
from gsdr_tpu.pipelines import FmChannelizer


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def main():
    fs = 2_048_000.0
    k = 32                       # channels on the Fs/K grid
    dec = k                      # critically sampled
    taps = lowpass(8 * k, 0.4 / k)   # Q = 8 grid periods: the PFB regime
    deviation = 12_000.0
    n = 1 << 18

    channels = tuple(-fs / 2 + (fs / k) * c for c in range(k))
    tones = tuple(300.0 + 83.0 * c for c in range(k))

    model = FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=channels, frequency_deviation=deviation,
        decimation=dec, low_pass_taps=taps,
        impl="pfb" if "--pfb" in sys.argv else "auto")

    t = np.arange(n) / fs
    rf = np.zeros(n, np.complex128)
    rng = np.random.default_rng(0)
    for f, tone in zip(channels, tones):
        msg = np.sin(2 * np.pi * tone * t + rng.uniform(0, 6))
        rf += (1.0 / k) * np.exp(
            1j * (2 * np.pi * f * t + (deviation / tone) * msg))
    block = ComplexArray(np.asarray(rf.real, np.float32),
                         np.asarray(rf.imag, np.float32))

    step = jax.jit(model.step)
    state = model.init()
    state, audio = step(state, block)
    audio = np.asarray(audio)
    print(f"audio: {audio.shape} at {fs / dec:.0f} Hz/channel "
          f"(impl={model.impl})")

    ok = True
    arate = fs / dec
    for c, tone in enumerate(tones):
        a = audio[c, 256:] - np.mean(audio[c, 256:])
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = np.argmax(spec) * arate / len(a)
        good = abs(peak - tone) < arate / len(a) * 2
        ok &= good
        if c % 8 == 0 or not good:
            print(f"  ch {c:2d} ({channels[c] / 1e3:+8.1f} kHz): "
                  f"tone {peak:7.1f} Hz (want {tone:7.1f}) "
                  f"{'ok' if good else 'MISS'}")
    print("all channels recovered" if ok else "RECOVERY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
