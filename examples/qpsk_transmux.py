"""Example: channelized QPSK digital link (transmultiplexer, round 5).

K independent QPSK symbol streams become ONE wideband signal through the
PFB SYNTHESIS bank (each channel's symbol stream is its baseband at
Fs/K; the prototype shapes the pulses), cross an AWGN channel, and come
back through the ANALYSIS bank; a pilot-based one-tap equalizer per
channel (complex gain via least squares on known symbols — the filter
cascade is flat enough in-band that one tap suffices) precedes QPSK
decisions. This is the digital-link composition of the reference's
QPSK modem (/root/reference/src/qpsk.cu) with the framework's
beyond-parity channel banks — a software transmultiplexer.

Run from the repo root:

    python examples/qpsk_transmux.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:  # force CPU before any backend init
    import jax as _jax
    _jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.pfb import pfb_channelize, pfb_synthesize
from gsdr_tpu.ops.qpsk import qpsk_modulate_symbols


def lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float64)


def run_transmux(k, m_syms, snr_db=25.0, q=8, n_pilots=256, seed=0):
    """K QPSK streams -> synthesize -> AWGN -> channelize -> equalize.

    Returns (per-channel SER array, per-channel EVM array, total symbol
    count compared).
    """
    rng = np.random.default_rng(seed)
    taps = lowpass(q * k, 0.5 / k)

    syms = rng.integers(0, 4, (k, m_syms)).astype(np.int32)
    # symbol-VALUE modulator (qpsk_modulate takes PACKED bytes — using
    # it here transmitted a 4x-expanded stream, 3/4 of it the constant
    # (+A,+A) point; round-5 review finding)
    tx = qpsk_modulate_symbols(jnp.asarray(syms), 1.0)       # (K, M)
    wide = pfb_synthesize(tx, taps, k).to_numpy()

    p_sig = float(np.mean(np.abs(wide) ** 2))
    sigma = np.sqrt(p_sig / (10.0 ** (snr_db / 10.0)) / 2.0)
    noisy = wide + sigma * (rng.standard_normal(wide.shape)
                            + 1j * rng.standard_normal(wide.shape))
    rx = pfb_channelize(
        ComplexArray(np.asarray(noisy.real, np.float32),
                     np.asarray(noisy.imag, np.float32)), taps, k)
    y = rx.to_numpy()                       # (K, M - Q + 1)
    s = tx.to_numpy()

    # frame-delay estimate from channel 0's pilot correlation (the
    # synthesis+analysis cascade is frame-aligned by the shared j*K
    # window convention, but don't hard-code it)
    best = (0, -1.0)
    for d in range(0, 2 * q):
        span = min(y.shape[1], m_syms - d) - 4
        c0 = abs(np.vdot(s[0, d:d + n_pilots], y[0, :n_pilots]))
        if c0 > best[1]:
            best = (d, c0)
        if span <= n_pilots:
            break
    d = best[0]
    span = min(y.shape[1], m_syms - d) - 4

    sers, evms = [], []
    for c in range(k):
        ref = s[c, d:d + span]
        # one-tap LS equalizer from the first n_pilots known symbols:
        # y ~ g*ref  =>  g_hat = <ref, y>/<ref, ref>  (np.vdot
        # conjugates its FIRST argument — no extra conjugate, which
        # would DOUBLE any channel phase; round-5 review finding)
        g = (np.vdot(ref[:n_pilots], y[c, :n_pilots])
             / np.vdot(ref[:n_pilots], ref[:n_pilots]))
        z = y[c, :span] / g
        evms.append(float(np.sqrt(np.mean(np.abs(z - ref) ** 2)
                                  / np.mean(np.abs(ref) ** 2))))
        dec = ((np.real(z) < 0).astype(int)
               + 2 * (np.imag(z) < 0).astype(int))
        dref = ((np.real(ref) < 0).astype(int)
                + 2 * (np.imag(ref) < 0).astype(int))
        sers.append(float(np.mean(dec != dref)))
    return np.asarray(sers), np.asarray(evms), span * k


def main():
    k, m = 64, 4096
    sers, evms, tot = run_transmux(k, m, snr_db=25.0)
    print(f"transmux: {k} QPSK channels x {m} symbols, 25 dB AWGN")
    print(f"  EVM mean {evms.mean():.3f} max {evms.max():.3f}")
    print(f"  SER mean {sers.mean():.2e} worst {sers.max():.2e} "
          f"({tot} symbols)")
    # EVM ~0.24 is the critical cascade's structural full-rate ISI (the
    # Nyquist packing bound of a critically sampled bank); QPSK's margin
    # (0.707 to the boundary) dwarfs it, hence SER 0 — denser
    # constellations need sub-rate symbols or OQAM phasing.
    ok = sers.max() < 1e-3 and evms.max() < 0.3
    print("link ok" if ok else "LINK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
