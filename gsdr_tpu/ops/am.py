"""AM demodulation chain: mix -> FIR low-pass + decimate -> envelope.

Parity with gsdrAmDemod (/root/reference/src/am.cu:52-81, kernel :21-50,
API include/gsdr/am.h:25-37). The reference fuses the whole chain in one
CUDA kernel per output sample; here the jnp composition lets XLA fuse the
elementwise stages around the conv.
"""

from gsdr_tpu.ops.fir import fir
from gsdr_tpu.ops.mixer import freq_shift
from gsdr_tpu.ops.quad_demod import quad_am_demod


def am_demod(
    x,
    low_pass_taps,
    rf_sample_rate,
    tuning_frequency,
    channel_frequency,
    decimation=1,
    first_sample_index=0,
    impl="auto",
):
    """Demodulate one AM channel out of a tuned complex RF stream.

    Args:
      x: complex64 baseband RF samples, shape (..., N).
      low_pass_taps: real FIR taps (T,), pre-reversed per the fir() contract.
      rf_sample_rate / tuning_frequency / channel_frequency: static scalars;
        the channel is mixed to DC with freq_shift = tuning - channel
        (src/am.cu:68).
      decimation: FIR output stride.
      first_sample_index: global index of x[..., 0] for oscillator phase
        continuity (src/am.cu:67); exact for arbitrarily long streams.

    Returns:
      (..., (N - T)//D + 1) float32 envelope samples: 2*clamp(|lpf|,0,1) - 1
      (src/am.cu:49).

    impl: 'auto' / 'xla' — the composed XLA chain (no kernel serves AM).
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"am_demod: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    shift_hz = float(tuning_frequency) - float(channel_frequency)
    mixed = freq_shift(x, shift_hz, rf_sample_rate, first_sample_index)
    filtered = fir(mixed, low_pass_taps, decimation)
    return quad_am_demod(filtered)
