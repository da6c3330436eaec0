"""QPSK and QPSK256 modem pipelines (mod -> channel -> demod loopback).

The application pattern of the reference's modem family
(/root/reference/src/qpsk.cu, src/qpsk256.cu): packed data bytes ->
constellation samples at the transmitter; received samples -> hard
decisions -> packed bytes at the receiver. The reference's 2x/4x/8x
multi-stream kernel explosion (src/qpsk.cu:148-219,500-585) is a leading
channel axis here, so one jitted step serves any number of parallel streams
— and the channel axis is what gsdr_tpu.parallel shards across chips.
"""

from dataclasses import dataclass

import jax.numpy as jnp

from gsdr_tpu.ops.qpsk import (
    pack_2bit_symbols,
    qpsk_demodulate_symbols,
    qpsk_modulate,
)
from gsdr_tpu.ops.qpsk256 import (
    CIRCULAR,
    RECTANGULAR,
    qpsk256_constellation,
    qpsk256_demodulate,
    qpsk256_demodulate_circular,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_circular,
    qpsk256_modulate_rect,
)


@dataclass(frozen=True)
class QpskModem:
    """4-ary PSK modem. tx: packed bytes -> planar symbols; rx: symbols ->
    packed int32 bytes (the planar path carries bytes as int32)."""

    amplitude: float = 1.0

    def tx(self, packed_bytes, num_symbols=None):
        return qpsk_modulate(
            packed_bytes, amplitude=self.amplitude,
            num_symbols=num_symbols, planar=True,
        )

    def rx(self, samples, out_dtype=jnp.int32):
        return pack_2bit_symbols(
            qpsk_demodulate_symbols(samples), out_dtype=out_dtype
        )

    def loopback(self, packed_bytes, channel_fn=None):
        """tx -> optional channel impairment -> rx; returns packed bytes."""
        s = self.tx(packed_bytes)
        if channel_fn is not None:
            s = channel_fn(s)
        return self.rx(s)


@dataclass(frozen=True)
class Qpsk256Modem:
    """256-ary modem over either reference constellation geometry.

    The constellation is an ordinary array built once host-side (vs the
    reference's device init kernel + __constant__ upload,
    src/qpsk256.cu:262-295); demod is the matmul nearest-neighbor
    (gsdr_tpu.ops.qpsk256)."""

    constellation_type: int = RECTANGULAR
    amplitude: float = 1.0
    # force the table-exact paths (full-table modulate select-sum,
    # exhaustive 256-point NN demod) instead of the arithmetic fast
    # paths. The fast paths are bit-identical for RECTANGULAR; for
    # CIRCULAR the arithmetic modulator is within f32 sin/cos accuracy
    # (~1e-7) of the table and the ring demod differs from exhaustive
    # only on exact Voronoi-boundary ties (ops/qpsk256.py round-3 notes).
    exact_tables: bool = False

    def constellation(self):
        return qpsk256_constellation(
            self.constellation_type, self.amplitude, planar=True
        )

    def tx(self, symbol_bytes):
        if not self.exact_tables:
            if self.constellation_type == RECTANGULAR:
                # arithmetic fast path (no table gather), bit-identical
                return qpsk256_modulate_rect(symbol_bytes, self.amplitude)
            if self.constellation_type == CIRCULAR:
                return qpsk256_modulate_circular(symbol_bytes,
                                                 self.amplitude)
        return qpsk256_modulate(symbol_bytes, self.constellation())

    def rx(self, samples, out_dtype=jnp.int32):
        if not self.exact_tables:
            if self.constellation_type == RECTANGULAR:
                # exact per-axis quantization, O(1) per sample
                return qpsk256_demodulate_rect(samples, self.amplitude,
                                               out_dtype=out_dtype)
            if self.constellation_type == CIRCULAR:
                # ring-decomposed NN, 11 candidates instead of 256
                return qpsk256_demodulate_circular(samples, self.amplitude,
                                                   out_dtype=out_dtype)
        return qpsk256_demodulate(samples, self.constellation(),
                                  out_dtype=out_dtype)

    def loopback(self, symbol_bytes, channel_fn=None):
        s = self.tx(symbol_bytes)
        if channel_fn is not None:
            s = channel_fn(s)
        return self.rx(s)
