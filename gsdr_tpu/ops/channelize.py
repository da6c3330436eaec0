"""Fused mix -> FIR -> decimate for a bank of channels as ONE conv.

The reference's fused chain (/root/reference/src/adjustFrequency.cu:25-56
inside k_Am/k_Fm) evaluates, per channel c and output j:

    filt[c, j] = sum_t x[j*D + t] * e^{j*phi_c(j*D + t)} * h[t]

Because the LO is a pure exponential, the phase splits exactly:
e^{j*phi_c(jD+t)} = e^{j*phi_c(jD)} * e^{j*2*pi*f_c*t/Fs}. Folding the
second factor into the taps gives channel-specific complex taps
g_c[t] = h[t] * e^{j*2*pi*f_c*t/Fs} (host-precomputed in float64), so

    filt[c, j] = e^{j*phi_c(jD)} * sum_t x[jD + t] * g_c[t]

— the whole C-channel mix+FIR+decimate collapses into one real convolution
with input features (xr, xi) and 2C output features (contraction size 2T).
The per-sample LO (C transcendental pairs per input sample in the naive
path) shrinks to one phasor per *decimated* output via the exact
digit-table phase (gsdr_tpu.utils.phase), and the FM discriminator needs
not even that: consecutive rotors differ by the constant lo(D)
(fm_discriminate_bank).

This replaces the reference's per-thread tap-loop-with-sincos hot loop
(src/adjustFrequency.cu:36-55).
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from gsdr_tpu.carray import ComplexArray, expj
from gsdr_tpu.utils.phase import phase_digit_table, phase_fraction_from_table

_TWO_PI = 6.283185307179586


def make_complex_tap_bank(taps, shifts_hz, sample_rate):
    """Host-side (2C, 2, T) conv kernel of channelized complex taps.

    Rows 2c / 2c+1 produce the real / imag planes of channel c:
      kernel[2c]   = [ gr_c, -gi_c ]   (applied to input features [xr, xi])
      kernel[2c+1] = [ gi_c,  gr_c ]
    with g_c[t] = taps[t] * e^{j*2*pi*frac(f_c*t/Fs)}, phase fractions exact
    (integer arithmetic) for integral f/Fs, float64 otherwise.
    """
    taps = np.asarray(taps, np.float64)
    t_len = taps.shape[0]
    t_idx = np.arange(t_len)
    kernel = np.zeros((2 * len(shifts_hz), 2, t_len), np.float64)
    for c, f in enumerate(shifts_hz):
        f, fs = float(f), float(sample_rate)
        if f.is_integer() and fs.is_integer():
            frac = ((int(f) % int(fs)) * t_idx % int(fs)) / int(fs)
        else:
            frac = np.mod(f * t_idx, fs) / fs
        g = taps * np.exp(2j * np.pi * frac)
        kernel[2 * c, 0] = g.real
        kernel[2 * c, 1] = -g.imag
        kernel[2 * c + 1, 0] = g.imag
        kernel[2 * c + 1, 1] = g.real
    # numpy (not jnp) on purpose: the bank is a host-side constant even
    # when built under an active jit trace.
    return kernel.astype(np.float32)


def mix_fir_decimate_bank(x, kernel, decimation, impl="auto"):
    """Apply a complex tap bank to planar x (..., N) -> planar (..., C, M).

    ``kernel`` is from make_complex_tap_bank; M = (N - T)//D + 1. The
    un-rotated output: caller applies rotate_bank for true mixed semantics
    (the rotation commutes past the filter exactly).

    impl: 'auto' / 'xla' — the float32 conv (cuDNN on the GPU); no
    hand-written kernel serves the bank alone.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"mix_fir_decimate_bank: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    lead = x.shape[:-1]
    n = x.shape[-1]
    lhs = jnp.stack([x.re, x.im], axis=-2).reshape((-1, 2, n))  # (B, 2, N)
    out = lax.conv_general_dilated(
        lhs, kernel,
        window_strides=(decimation,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )  # (B, 2C, M)
    m = out.shape[-1]
    c = kernel.shape[0] // 2
    out = out.reshape(lead + (c, 2, m))
    return ComplexArray(out[..., 0, :], out[..., 1, :])


def lo_phasor(table, idx):
    """e^{2i pi frac(f_c * idx / Fs)} per channel for one (traced) int32
    index: planar (C, 1), exact phase fractions from the digit table."""
    frac = phase_fraction_from_table(
        jnp.reshape(jnp.asarray(idx, jnp.int32), (1,)),
        jnp.asarray(table, jnp.float32)[:, None, :])
    return expj(_TWO_PI * frac)


def discriminator_prev(carry, table, rot0, decimation):
    """The discriminator's carried (rotated) sample, brought into the
    un-rotated frame of a block whose window 0 starts at ``rot0``.

    The rotor of output j times the conjugate rotor of output j-1 is the
    constant lo(D) for every j, so an un-rotated bank output y satisfies
    y_rot[j] conj(y_rot[j-1]) = y[j] conj(y[j-1]) lo(D). The carried
    sample is rotated; this returns u with y[0] conj(u) lo(D) =
    y_rot[0] conj(carry), i.e. u = carry conj(lo(rot0)) lo(D)."""
    return (carry * lo_phasor(table, rot0).conj()
            * lo_phasor(table, decimation))


def discriminator_carry(y_last, table, rot0_next, decimation):
    """The inverse of discriminator_prev: the last un-rotated output of a
    block, rotated into the carried state, such that the next block (window
    0 at ``rot0_next``) recovers it exactly. Equal to
    y_last lo(rot0_next - D); written as the product
    lo(rot0_next) conj(lo(D)) so that the two phasors cancel against
    discriminator_prev's to float rounding, not to the digit table's."""
    return (y_last * lo_phasor(table, rot0_next)
            * lo_phasor(table, decimation).conj())


def fm_discriminate_bank(y, prev, table, decimation, gain):
    """FM discriminator over un-rotated bank outputs y (..., C, M):
    gain * angle(y[j] conj(y[j-1]) lo(D)), with y[-1] = ``prev`` (C, 1)
    from discriminator_prev. Equal to rotate_bank then quad_fm_demod, but
    the per-output rotor never has to be evaluated, so its phase rounding
    never enters the audio. A product that is exactly zero (the zero
    carry of a cold start) demodulates to 0, not to the +-pi that signed
    zeros would give atan2."""
    step = lo_phasor(table, decimation)
    prior = ComplexArray(
        jnp.concatenate([prev.re, y.re[..., :-1]], axis=-1),
        jnp.concatenate([prev.im, y.im[..., :-1]], axis=-1))
    q = y * prior.conj() * step
    return jnp.where((q.re == 0) & (q.im == 0), 0.0,
                     gain * jnp.arctan2(q.im, q.re))


def rotate_bank(y, table, n0, decimation):
    """Multiply y (..., C, M) by e^{j*phi_c(n0 + j*D)} per channel/output.

    ``table`` is the (C, 4) digit-fraction table of the shift frequencies
    (phase_digit_table); ``n0`` may be traced (carried stream offset).
    """
    m = y.shape[-1]
    idx = n0 + decimation * jnp.arange(m, dtype=jnp.int32)
    frac = phase_fraction_from_table(idx[None, :], table[:, None, :])
    lo = expj(_TWO_PI * frac)
    return ComplexArray(
        y.re * lo.re - y.im * lo.im,
        y.re * lo.im + y.im * lo.re,
    )


def channelize(x, taps, shifts_hz, sample_rate, decimation=1,
               first_sample_index=0):
    """One-call fused channelizer: planar x (N,) -> planar (C, (N-T)//D+1).

    Equivalent to freq_shift per channel followed by fir(…, decimation) but
    in one conv; shifts/sample_rate/decimation are static.
    """
    kernel = make_complex_tap_bank(taps, shifts_hz, sample_rate)
    table = jnp.asarray(phase_digit_table(shifts_hz, sample_rate))
    y = mix_fir_decimate_bank(x, kernel, decimation)
    n0 = jnp.asarray(int(first_sample_index) % int(round(sample_rate)),
                     jnp.int32)
    return rotate_bank(y, table, n0, decimation)
