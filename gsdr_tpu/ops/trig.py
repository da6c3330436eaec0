"""Oscillator / trig signal generators.

Parity with gsdrCosineC / gsdrCosineF (/root/reference/src/trig.cu:47-75):
generate N samples along a linear phase ramp from phi_begin with per-sample
increment (phi_end - phi_begin) / N (the ramp endpoint is exclusive, matching
src/trig.cu:56). The reference's thread-per-sample grid becomes a vectorized
iota; the per-sample increment is computed in float64 on the host exactly as
the reference does (static_cast<float> of a double division, src/trig.cu:56).
"""

import jax.numpy as jnp

from gsdr_tpu.carray import expj


def _phase_ramp(phi_begin, phi_end, num_elements):
    step = jnp.float32((float(phi_end) - float(phi_begin)) / float(num_elements))
    i = jnp.arange(num_elements, dtype=jnp.float32)
    return jnp.float32(phi_begin) + i * step


def cosine_c(phi_begin, phi_end, num_elements, planar=False):
    """Complex exponential e^{j*theta_i}: cos(theta) + j*sin(theta).

    Matches k_ComplexCosine (src/trig.cu:20-34): real part is cos, imaginary
    part is sin. ``planar=True`` returns a ComplexArray (planar path).
    """
    theta = _phase_ramp(phi_begin, phi_end, num_elements)
    lo = expj(theta)
    return lo if planar else lo.to_complex()


def cosine_f(phi_begin, phi_end, num_elements):
    """Real cosine along the phase ramp — k_RealCosine (src/trig.cu:36-45)."""
    theta = _phase_ramp(phi_begin, phi_end, num_elements)
    return jnp.cos(theta)
