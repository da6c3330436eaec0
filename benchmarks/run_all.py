"""Benchmark suite over the BASELINE.json configurations, on the GPU.

    python -m benchmarks.run_all

One JSON line per configuration, each naming the device; the script exits
non-zero without a GPU. Timing: gsdr_tpu.utils.timing (windows of chained
steps, each ended by jax.block_until_ready).
"""

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.fir import fir
from gsdr_tpu.ops.mixer import freq_shift
from gsdr_tpu.pipelines import AmReceiver, FmChannelizer, QpskModem, \
    Qpsk256Modem
from gsdr_tpu.utils.compile_cache import enable_compile_cache
from gsdr_tpu.utils.timing import time_step


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _noise(n, seed=0):
    r = np.random.default_rng(seed)
    return ComplexArray(
        jnp.asarray(r.standard_normal(n), jnp.float32),
        jnp.asarray(r.standard_normal(n), jnp.float32),
    )


def bench_am(n, iters):
    """Config 1: AM demod, 64K+ samples."""
    model = AmReceiver(
        sample_rate=1e6, tuning_frequency=0.0,
        channel_frequencies=(100_000.0,), decimation=4,
        low_pass_taps=_lowpass(64, 0.05))
    rf = _noise(n)
    sec = time_step(model.step, model.init(), rf, iters=iters)
    return {"metric": "am_demod_1ch_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_shift_fir(n, iters):
    """Config 2: freq shift + 64-tap FIR, 4x decimation."""
    taps = jnp.asarray(_lowpass(64, 0.1))

    def step(state, x):
        # loop-carried dependence defeats hoisting (timing.py docstring)
        mixed = freq_shift(x + state, 12_345.0, 1e6)
        y = fir(mixed, taps, 4)
        return (jnp.sum(y.re) + jnp.sum(y.im)) * 1e-30, y

    rf = _noise(n)
    sec = time_step(step, jnp.float32(0.0), rf, iters=iters)
    return {"metric": "shift_fir64_dec4_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_fm(n, iters, impl="xla", nch=16):
    """Config 3 (flagship): C-channel FM chain incl. de-emphasis;
    impl='auto' is the path that serves (the fused kernel on a GPU)."""
    model = FmChannelizer(
        sample_rate=1e6, tuning_frequency=0.0,
        channel_frequencies=tuple(-480_000.0 + (960_000.0 / nch) * i
                                  for i in range(nch)),
        frequency_deviation=75_000.0, decimation=4,
        low_pass_taps=_lowpass(64, 0.03), impl=impl)
    rf = _noise(n)
    sec = time_step(model.step, model.init(), rf, iters=iters)
    return {"metric": f"fm_channelizer_{nch}ch_{impl}_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_pfb(n, iters, k=16):
    """Uniform-grid PFB channelizer (beyond-parity op): K channels at
    critical decimation (XLA fold + DFT)."""
    from gsdr_tpu.ops.pfb import pfb_channelize

    taps = _lowpass(k * 8, 0.4 / k)
    rf = _noise(n)

    def step(state, x):
        y = pfb_channelize(
            ComplexArray(x.re + state, x.im), taps, k)
        return (jnp.sum(y.re) + jnp.sum(y.im)) * 1e-30, y

    sec = time_step(step, jnp.float32(0.0), rf, iters=iters)
    return {"metric": f"pfb_{k}ch_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_fm_wideband(n, iters, impl="pfb", dec=64, k=64):
    """Wideband uniform-grid FM chain: K channels on the Fs/K grid,
    decimated by ``dec``, 8K-tap prototype — the many-channel receiver
    shape where the PFB front's fold amortizes the filter over the grid.
    impl='pfb' runs the XLA PFB front; impl='auto' the dense front (the
    fused kernel where it supports the shape) on the SAME config."""
    model = FmChannelizer(
        sample_rate=1e6, tuning_frequency=0.0,
        channel_frequencies=tuple(-(1e6 / k) * i for i in range(k)),
        frequency_deviation=75_000.0, decimation=dec,
        low_pass_taps=_lowpass(8 * k, 0.4 / k), impl=impl)
    rf = _noise(n)
    sec = time_step(model.step, model.init(), rf, iters=iters)
    name = "crit" if dec == k else f"d{dec}"
    return {"metric": f"fm_wideband_{k}ch_{name}_{impl}_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_am_wideband(n, iters, impl="pfb"):
    """Wideband uniform-grid AM: same grid/filter class as
    bench_fm_wideband."""
    k = 64
    model = AmReceiver(
        sample_rate=1e6, tuning_frequency=0.0,
        channel_frequencies=tuple(-(1e6 / k) * i for i in range(k)),
        decimation=k, low_pass_taps=_lowpass(512, 0.4 / k), impl=impl)
    rf = _noise(n)
    sec = time_step(model.step, model.init(), rf, iters=iters)
    return {"metric": f"am_wideband_64ch_crit_{impl}_input_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def bench_qpsk(n, iters):
    """Config 4: QPSK mod/demod loopback."""
    modem = QpskModem()
    data = jnp.asarray(
        np.random.default_rng(0).integers(0, 4, n), jnp.int32)

    def step(state, d):
        from gsdr_tpu.ops.qpsk import qpsk_demodulate_symbols
        # integer data dependence on the carried state defeats CSE/hoisting
        d = (d + state.astype(jnp.int32)) % 4
        # sign arithmetic, not a table gather (ops/qpsk.py)
        s = ComplexArray(
            1.0 - 2.0 * jnp.bitwise_and(d, 1).astype(jnp.float32),
            1.0 - 2.0 * (jnp.right_shift(d, 1) & 1).astype(jnp.float32))
        out = qpsk_demodulate_symbols(s)
        # full-output dependence: out[0]-only let XLA demodulate ONE symbol
        return (jnp.sum(out) % 1021).astype(jnp.float32), out

    sec = time_step(step, jnp.zeros(()), data, iters=iters)
    return {"metric": "qpsk_loopback_msym_s",
            "value": n / sec / 1e6, "unit": "Msymbols/s"}


def bench_qpsk256(n, iters, ctype=None, awgn=False):
    """Config 5 shape (single-chip portion): 256-ary loopback.

    Rectangular uses the O(1) arithmetic fast paths; circular the
    round-3 ring-arithmetic mod + ring-NN demod (exhaustive NN stays
    the ops-level default). ``awgn=True`` adds a precomputed complex
    noise vector between tx and rx (round-3 honesty row: the clean
    composite is constant-folding-prone and unrepresentative of a
    deployed link; the noise is fixed across iterations, which keeps the
    channel add live because tx varies with the carried state)."""
    from gsdr_tpu.ops.qpsk256 import RECTANGULAR

    ctype = RECTANGULAR if ctype is None else ctype
    modem = Qpsk256Modem(constellation_type=ctype)
    syms = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, n), jnp.int32)
    r = np.random.default_rng(1)
    sigma = 0.05 if awgn else 0.0  # ~20 dB SNR at unit-ish symbol power
    nre = jnp.asarray(sigma * r.standard_normal(n), jnp.float32)
    nim = jnp.asarray(sigma * r.standard_normal(n), jnp.float32)

    def step(state, s):
        s = (s + state.astype(jnp.int32)) % 256
        tx = modem.tx(s)
        if awgn:
            tx = ComplexArray(tx.re + nre, tx.im + nim)
        out = modem.rx(tx)
        return (jnp.sum(out) % 1021).astype(jnp.float32), out

    name = "rect" if ctype == RECTANGULAR else "circ"
    if awgn:
        name += "_awgn"
    sec = time_step(step, jnp.zeros(()), syms, iters=iters)
    return {"metric": f"qpsk256_loopback_{name}_msym_s",
            "value": n / sec / 1e6, "unit": "Msymbols/s"}


def bench_iir(n, iters):
    """Standalone IIR biquad (the reference's flagship op,
    /root/reference/src/iir.cu): the exact blocked scan."""
    from gsdr_tpu.ops.iir import iir_block

    b = np.array([0.0675, 0.135, 0.0675], np.float32)
    a = np.array([1.0, -1.143, 0.413], np.float32)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(n).astype(np.float32))

    def step(state, xx):
        y, zf = iir_block(b, a, xx + state * 1e-30)
        return zf[0], y

    sec = time_step(step, jnp.float32(0.0), x, iters=iters)
    return {"metric": "iir_biquad_msps",
            "value": n / sec / 1e6, "unit": "Msamples/s"}


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"run_all: no GPU (JAX found {dev.platform!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    n, iters = 1 << 20, 20
    rows = [
        lambda: bench_am(n, iters),
        lambda: bench_shift_fir(n, iters),
        lambda: bench_fm(n, iters, impl="xla"),
        lambda: bench_fm(n, iters, impl="auto"),
        lambda: bench_fm(n, iters, impl="auto", nch=64),
        lambda: bench_pfb(n, iters),
        lambda: bench_fm_wideband(n, iters, impl="pfb"),
        lambda: bench_fm_wideband(n, iters, impl="auto"),
        lambda: bench_fm_wideband(n, iters, impl="pfb", dec=8),
        lambda: bench_fm_wideband(n, iters, impl="pfb", dec=128, k=128),
        lambda: bench_am_wideband(n, iters, impl="pfb"),
        lambda: bench_qpsk(n, iters),
        lambda: bench_qpsk256(min(n, 1 << 19), iters),
        lambda: bench_qpsk256(min(n, 1 << 19), iters, ctype=1),  # CIRC rings
        lambda: bench_qpsk256(min(n, 1 << 19), iters, awgn=True),
        lambda: bench_qpsk256(min(n, 1 << 19), iters, ctype=1, awgn=True),
        lambda: bench_iir(n, iters),
    ]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    # print as each row lands (a late failure must not eat earlier rows)
    failed = False
    for row in rows:
        try:
            r = row()
        except Exception as e:
            r = {"error": str(e)[:160]}
            failed = True
        r["device"] = device
        print(json.dumps(r), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
