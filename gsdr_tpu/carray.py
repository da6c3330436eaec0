"""Planar complex representation: split re/im float32 arrays.

The models, kernels and sharded layer represent complex signals as a
``ComplexArray`` pytree of two float32 planes rather than complex64 arrays:
Pallas kernels have no complex dtype, so split re/im is the layout every
kernel needs internally anyway (SURVEY.md section 7, hard part 5). Whether
complex64 would serve the XLA paths as well on the GPU is an open question
(ROADMAP).

The complex64-dtype API of each op still exists (convenient on CPU and for
test goldens); ops dispatch on input type: complex64 in -> complex64 out,
ComplexArray in -> ComplexArray out. Models, kernels, benchmarks and the
sharded layer use ComplexArray exclusively.

Replaces the reference's cuComplex + operator overloads
(/root/reference/src/cuComplexOperatorOverloads.cuh:25-72).
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class ComplexArray:
    """A complex tensor as two same-shaped float32 planes."""

    re: jax.Array
    im: jax.Array

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_complex(cls, x):
        """Split a (numpy or jnp) complex array host/device-side."""
        if isinstance(x, np.ndarray):
            return cls(
                jnp.asarray(np.ascontiguousarray(x.real), dtype=jnp.float32),
                jnp.asarray(np.ascontiguousarray(x.imag), dtype=jnp.float32),
            )
        x = jnp.asarray(x)
        return cls(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))

    @classmethod
    def zeros(cls, shape, dtype=jnp.float32):
        return cls(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))

    # -- conversion --------------------------------------------------------
    def to_complex(self):
        """Recombine into complex64."""
        return jax.lax.complex(self.re, self.im)

    def to_numpy(self):
        return np.asarray(self.re) + 1j * np.asarray(self.im)

    # -- shape plumbing ------------------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx):
        return ComplexArray(self.re[idx], self.im[idx])

    def reshape(self, *shape):
        return ComplexArray(self.re.reshape(*shape), self.im.reshape(*shape))

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(self.re + other.re, self.im + other.im)
        return ComplexArray(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(self.re - other.re, self.im - other.im)
        return ComplexArray(self.re - other, self.im)

    def __mul__(self, other):
        if isinstance(other, ComplexArray):
            return ComplexArray(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return ComplexArray(self.re * other, self.im * other)

    def conj(self):
        return ComplexArray(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        return jnp.hypot(self.re, self.im)


def is_planar(x):
    return isinstance(x, ComplexArray)


def as_planar(x):
    """Coerce complex64 / real / planar input to ComplexArray."""
    if isinstance(x, ComplexArray):
        return x
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return ComplexArray.from_complex(x)
    z = x.astype(jnp.float32)
    return ComplexArray(z, jnp.zeros_like(z))


def expj(theta):
    """e^{j*theta} as a ComplexArray."""
    return ComplexArray(jnp.cos(theta), jnp.sin(theta))
