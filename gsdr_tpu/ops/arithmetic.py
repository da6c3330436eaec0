"""Elementwise arithmetic primitives.

Capability parity with the reference's arithmetic ops
(/root/reference/include/gsdr/arithmetic.h:26-95, src/add_const.cu,
src/multiply.cu, src/magnitude.cu), rebuilt as polymorphic jnp ops: the
reference's four dtype-combo variants per op (FF/CC/CF/FC) collapse into one
function via JAX dtype promotion, and its one-thread-per-element CUDA grids
become XLA elementwise fusions.

Note: the reference guards elementwise kernels with ``x > numElements``
(one-element overwrite bug, src/add_const.cu:23); value semantics here make
that class of bug impossible.
"""

import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, is_planar


def add_const(x, c):
    """out[i] = x[i] + c.

    Covers gsdrAddConstFF/CC/CF/FC (include/gsdr/arithmetic.h:26-56) through
    dtype promotion. Matching the reference's complex+float overload
    (src/cuComplexOperatorOverloads.cuh:51-53), adding a real constant to a
    complex input adds to the real part only — which is ordinary complex
    arithmetic, so no special casing is needed. On the planar path a complex
    Python scalar ``c`` adds per-plane.
    """
    if is_planar(x):
        c = complex(c)
        return ComplexArray(x.re + jnp.float32(c.real), x.im + jnp.float32(c.imag))
    x = jnp.asarray(x)
    return x + c


def add_to_magnitude(x, k):
    """Add ``k`` to the magnitude of each complex sample, preserving phase.

    out[i] = (|x[i]| + k) * x[i] / |x[i]|  — gsdrAddToMagnitude semantics
    (src/add_const.cu:30-42). Where |x[i]| == 0 the phase is undefined; the
    reference produces NaN there (division by zero), we define the result as
    ``k + 0j`` (a point at magnitude k with phase 0).
    """
    if is_planar(x):
        mag = x.abs()
        safe = jnp.where(mag > 0, mag, 1.0)
        scale = (mag + k) / safe
        return ComplexArray(
            jnp.where(mag > 0, x.re * scale, jnp.float32(k)),
            jnp.where(mag > 0, x.im * scale, 0.0),
        )
    x = jnp.asarray(x)
    mag = jnp.abs(x)
    safe = jnp.where(mag > 0, mag, 1.0)
    scaled = x * ((mag + k) / safe)
    return jnp.where(mag > 0, scaled, jnp.asarray(k, dtype=x.dtype))


def multiply(x, y):
    """out[i] = x[i] * y[i].

    Covers gsdrMultiplyCC/FF/CF (include/gsdr/arithmetic.h:58-80) via dtype
    promotion; complex multiplication replaces cuCmulf (src/multiply.cu:21-28).
    ComplexArray operands use the planar product.
    """
    if is_planar(x):
        return x * (y if is_planar(y) else jnp.asarray(y))
    if is_planar(y):
        return y * jnp.asarray(x)
    return jnp.multiply(jnp.asarray(x), jnp.asarray(y))


def magnitude(x):
    """out[i] = |x[i]| = hypot(re, im) — gsdrMagnitude (src/magnitude.cu:20-28)."""
    if is_planar(x):
        return x.abs()
    return jnp.abs(jnp.asarray(x)).astype(jnp.float32)


def absolute(x):
    """out[i] = |x[i]| for real input — gsdrAbs (src/magnitude.cu:30-37)."""
    return jnp.abs(jnp.asarray(x))
