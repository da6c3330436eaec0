"""Quadrature demodulators.

Parity with gsdrQuadFmDemod / gsdrQuadAmDemod
(/root/reference/src/quad_demod.cu:23-54). Both dispatch on representation:
ComplexArray (planar path) or complex64 arrays.
"""

import jax.numpy as jnp

from gsdr_tpu.carray import is_planar


def quad_fm_demod(x, gain):
    """Quadrature FM discriminator.

    out[i] = gain * atan2(Im, Re) of x[i+1] * conj(x[i])
    (src/quad_demod.cu:30-32). Produces N-1 outputs from N inputs — the
    reference's numOut+1 input contract (include/gsdr/quad_demod.h:25-29).
    ``gain`` is conventionally Fs / (2*pi*frequency_deviation)
    (include/gsdr/quad_demod.h:28, src/fm.cu:203).
    """
    if is_planar(x):
        r0, i0 = x.re[..., :-1], x.im[..., :-1]
        r1, i1 = x.re[..., 1:], x.im[..., 1:]
        # x[i+1] * conj(x[i])
        m_re = r1 * r0 + i1 * i0
        m_im = i1 * r0 - r1 * i0
        return gain * jnp.arctan2(m_im, m_re)
    x = jnp.asarray(x)
    m = x[..., 1:] * jnp.conj(x[..., :-1])
    return gain * jnp.arctan2(m.imag, m.real)


def quad_am_demod(x):
    """AM envelope detector.

    out[i] = 2 * clamp(|x[i]|, 0, 1) - 1 — the reference's
    scalbnf(__saturatef(hypot), 1) - 1 (src/quad_demod.cu:46-49).
    """
    mag = x.abs() if is_planar(x) else jnp.abs(jnp.asarray(x))
    return 2.0 * jnp.clip(mag, 0.0, 1.0) - 1.0
