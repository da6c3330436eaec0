"""Sharded modem pipelines: many independent QPSK/QPSK256 streams on a mesh.

BASELINE config 5: a 256-channel QPSK256 pipeline sharded across hosts.
Modem streams are independent (the reference's 4x pointer-arg kernels,
/root/reference/src/qpsk256.cu:104-151,198-259, were its way of batching
them), so the mesh maps cleanly: the channel axis shards streams, the time
axis shards each stream's symbol sequence — no halos at all (symbol
decisions are memoryless). What the distributed layer adds is placement +
the matmul demod (ops/qpsk256.py) running at full width per device.
"""

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.qpsk import qpsk_demodulate_symbols, qpsk_modulate_symbols
from gsdr_tpu.ops.qpsk256 import (
    RECTANGULAR,
    qpsk256_demodulate,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_rect,
)


def _shmap(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


def make_sharded_qpsk256_modem(modem, mesh):
    """(tx, rx) jittable functions over a ('channel', 'time') mesh.

    tx: symbol byte values int32 (S, N) -> planar samples (S, N);
    rx: planar samples (S, N) -> int32 symbol values (S, N).
    S (streams) shards over 'channel', N (symbols) over 'time'.
    """
    const = modem.constellation()  # planar (256,) ComplexArray
    rect = modem.constellation_type == RECTANGULAR
    amp = modem.amplitude

    def tx_body(sym, cre, cim):
        if rect:  # arithmetic fast path, bit-identical (ops/qpsk256.py)
            out = qpsk256_modulate_rect(sym, amp)
        else:
            out = qpsk256_modulate(sym, ComplexArray(cre, cim))
        return out.re, out.im

    def rx_body(sre, sim, cre, cim):
        if rect:
            return qpsk256_demodulate_rect(ComplexArray(sre, sim), amp,
                                           out_dtype=jnp.int32)
        return qpsk256_demodulate(ComplexArray(sre, sim),
                                  ComplexArray(cre, cim),
                                  out_dtype=jnp.int32)

    sh = P("channel", "time")
    rep = P(None)
    tx_m = _shmap(tx_body, mesh, in_specs=(sh, rep, rep),
                  out_specs=(sh, sh))
    rx_m = _shmap(rx_body, mesh, in_specs=(sh, sh, rep, rep),
                  out_specs=sh)

    def tx(symbols):
        re, im = tx_m(symbols, const.re, const.im)
        return ComplexArray(re, im)

    def rx(samples):
        return rx_m(samples.re, samples.im, const.re, const.im)

    return tx, rx


def make_sharded_qpsk_modem(modem, mesh):
    """(tx, rx) for the 4-ary modem over a ('channel', 'time') mesh.

    tx: 2-bit symbol values int32 (S, N) -> planar samples; rx: planar
    samples -> int32 symbol values. Byte pack/unpack stays host-side
    (gsdr_tpu.runtime pack_2bit) or in ops.qpsk — it reshapes, so sharding
    it over time would split mid-byte."""
    amp = modem.amplitude

    def tx_body(sym):
        # sign arithmetic, not a 4-entry table gather (ops/qpsk.py)
        out = qpsk_modulate_symbols(sym, amp)
        return out.re, out.im

    def rx_body(sre, sim):
        return qpsk_demodulate_symbols(ComplexArray(sre, sim))

    sh = P("channel", "time")
    tx_m = _shmap(tx_body, mesh, in_specs=(sh,), out_specs=(sh, sh))
    rx_m = _shmap(rx_body, mesh, in_specs=(sh, sh), out_specs=sh)

    def tx(symbols):
        re, im = tx_m(symbols)
        return ComplexArray(re, im)

    def rx(samples):
        return rx_m(samples.re, samples.im)

    return tx, rx
