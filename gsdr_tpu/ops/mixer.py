"""Frequency shifting (complex mixing / local oscillator).

Rebuilds the reference's k_AdjustFrequency device helper
(/root/reference/src/adjustFrequency.cu:25-56) as a standalone vectorized op.
The reference fuses {LO generation, multiply, FIR tap-weighting} in one
per-thread loop; here the LO/mix is a pure op (XLA fuses it with neighbors),
and gsdr_tpu.kernels provides the fully fused Pallas chain.

Semantics (the reference's *intent* — its own phase math is buggy, see
SURVEY.md section 2.2 and gsdr_tpu/utils/phase.py):

    out[n] = x[n] * exp(+j * 2*pi * freq_shift * (n0 + n) / Fs)

with freq_shift = tuning - channel (src/fm.cu:204, src/am.cu:68), so a
channel sitting at +delta Hz in the tuned baseband is shifted down to DC.
Phase continuity across calls comes arithmetically from the global sample
offset n0 — the reference's firstSampleIndex contract
(src/adjustFrequency.cuh:25) — and needs no communication or carried state.

All functions dispatch on representation: ComplexArray in -> ComplexArray
out (the planar path), complex64 in -> complex64 out (CPU convenience).
"""

import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, expj, is_planar
from gsdr_tpu.utils.phase import phase_fraction, phase_fraction_offset

_TWO_PI = 6.283185307179586


def lo_phase(num_elements, freq_hz, sample_rate, first_sample_index=0):
    """Oscillator phase theta_i = 2*pi*frac(f*(n0+i)/Fs), float32-exact for
    arbitrarily long streams (see gsdr_tpu.utils.phase)."""
    i = jnp.arange(num_elements, dtype=jnp.int32)
    frac0 = jnp.float32(phase_fraction_offset(first_sample_index, freq_hz, sample_rate))
    frac = phase_fraction(i, freq_hz, sample_rate) + frac0
    frac = frac - jnp.floor(frac)
    return _TWO_PI * frac


def lo_signal(num_elements, freq_hz, sample_rate, first_sample_index=0,
              planar=False):
    """Complex local oscillator e^{j*2*pi*f*(n0+i)/Fs}, i = 0..N-1."""
    theta = lo_phase(num_elements, freq_hz, sample_rate, first_sample_index)
    lo = expj(theta)
    return lo if planar else lo.to_complex()


def freq_shift(x, freq_shift_hz, sample_rate, first_sample_index=0):
    """Mix ``x`` by e^{j*2*pi*freq_shift*(n0+n)/Fs} along the last axis."""
    if is_planar(x):
        lo = lo_signal(x.shape[-1], freq_shift_hz, sample_rate,
                       first_sample_index, planar=True)
        return x * lo
    x = jnp.asarray(x)
    lo = lo_signal(x.shape[-1], freq_shift_hz, sample_rate, first_sample_index)
    return x * lo
