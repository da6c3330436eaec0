"""QPSK modulation / demodulation with packed-bit I/O.

Capability parity with the reference QPSK family
(/root/reference/src/qpsk.cu, API include/gsdr/qpsk.h:116-239).

Constellation (src/qpsk.cu:102-106):   00 -> (+A, +A)   01 -> (-A, +A)
                                       11 -> (-A, -A)   10 -> (+A, -A)

Bit packing: 4 symbols per byte, 2-bit fields LSB-first
(src/qpsk.cu:121-123). The reference's demodulator packs output bits with a
per-thread atomicCAS read-modify-write loop (src/qpsk.cu:261-267 — which is
not even a legal CUDA overload on uint8_t, SURVEY.md section 2.2 caveat 4);
here packing is a reshape + weighted sum, race-free by construction.

The reference's 2x/4x/8x multi-stream kernel families and the Templated<N>
consolidated-buffer variants (src/qpsk.cu:148-219,500-585,26-100) all
collapse into leading batch axes: every function here operates on the last
axis and broadcasts over any leading channel axes.

Representation notes: the planar path carries symbols/bytes as int32 —
pass ``out_dtype=jnp.int32`` and ``planar=True`` where applicable; the
defaults (uint8 / complex64) serve the convenience API.
"""

import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, is_planar


def qpsk_constellation(amplitude=1.0, dtype=jnp.complex64):
    """The 4-point table indexed by 2-bit symbol value."""
    re = jnp.array([1.0, -1.0, 1.0, -1.0]) * amplitude
    im = jnp.array([1.0, 1.0, -1.0, -1.0]) * amplitude
    return (re + 1j * im).astype(dtype)


def unpack_2bit_symbols(packed, num_symbols=None):
    """Byte values (..., nB) -> 2-bit symbol values (..., 4*nB), LSB-first.

    Accepts any integer dtype; computes in int32 and returns
    int32 symbol values in [0, 3].
    """
    packed = jnp.asarray(packed).astype(jnp.int32)
    shifts = jnp.arange(4, dtype=jnp.int32) * 2  # bit offsets 0,2,4,6
    sym = jnp.right_shift(packed[..., None], shifts) & 0x3
    sym = sym.reshape(packed.shape[:-1] + (packed.shape[-1] * 4,))
    if num_symbols is not None:
        sym = sym[..., :num_symbols]
    return sym


def pack_2bit_symbols(symbols, out_dtype=jnp.uint8):
    """2-bit symbol values (..., N) -> packed byte values (..., ceil(N/4)).

    Pads the tail with zero symbols when N is not a multiple of 4 (the
    reference's partial-byte fields are likewise zero-filled). Pass
    ``out_dtype=jnp.int32`` on the planar path.
    """
    symbols = jnp.asarray(symbols).astype(jnp.int32)
    n = symbols.shape[-1]
    pad = (-n) % 4
    if pad:
        symbols = jnp.pad(symbols, [(0, 0)] * (symbols.ndim - 1) + [(0, pad)])
    grp = symbols.reshape(symbols.shape[:-1] + ((n + pad) // 4, 4))
    weights = jnp.array([1, 4, 16, 64], dtype=jnp.int32)  # LSB-first 2-bit fields
    return jnp.sum(grp * weights, axis=-1).astype(out_dtype)


def qpsk_modulate_symbols(symbols, amplitude=1.0):
    """2-bit symbol values (..., N) int -> planar QPSK samples.

    The 4-point table is pure sign arithmetic: re flips on bit0, im on
    bit1 (00->(+,+), 01->(-,+), 10->(+,-), 11->(-,-)). Arithmetic
    instead of a table gather, and bit-identical (values are exactly +-a
    either way). Shared by qpsk_modulate and the sharded modem
    (parallel/modem.py)."""
    sym = jnp.asarray(symbols).astype(jnp.int32)
    a = float(amplitude)
    re = a * (1.0 - 2.0 * jnp.bitwise_and(sym, 1).astype(jnp.float32))
    im = a * (1.0 - 2.0 * (jnp.right_shift(sym, 1) & 1).astype(jnp.float32))
    return ComplexArray(re, im)


def qpsk_modulate(packed_bits, amplitude=1.0, num_symbols=None, planar=False):
    """Packed bytes -> QPSK symbols (complex64, or ComplexArray if planar).

    Parity with gsdrQpskModulate (src/qpsk.cu:366-389): each byte carries 4
    symbols, LSB-first; symbol values map per the Gray constellation above.
    """
    sym = unpack_2bit_symbols(packed_bits, num_symbols)
    out = qpsk_modulate_symbols(sym, amplitude)
    return out if planar else out.to_complex()


def qpsk_demodulate_symbols(x):
    """Complex samples -> 2-bit symbol values (quadrant sign decision).

    bit0 = 1 iff Re < 0, bit1 = 1 iff Im < 0 (src/qpsk.cu:239-254; boundary
    samples with Re == 0 or Im == 0 decide toward bit 0, matching the
    reference's >= 0 comparisons). Returns int32 values in [0, 3].
    """
    xp = x if is_planar(x) else ComplexArray.from_complex(jnp.asarray(x))
    b0 = (xp.re < 0).astype(jnp.int32)
    b1 = (xp.im < 0).astype(jnp.int32)
    return b0 | (b1 << 1)


def qpsk_demodulate(x, out_dtype=jnp.uint8):
    """Complex samples (..., N) -> packed byte values (..., ceil(N/4)).

    Parity with gsdrQpskDemodulate (src/qpsk.cu:391-412) minus its atomics.
    Pass ``out_dtype=jnp.int32`` on the planar path.
    """
    return pack_2bit_symbols(qpsk_demodulate_symbols(x), out_dtype=out_dtype)
