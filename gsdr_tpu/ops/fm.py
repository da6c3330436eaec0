"""FM demodulation chain: mix -> FIR low-pass + decimate -> quad discriminator.

Parity with gsdrFmDemod (/root/reference/src/fm.cu:181-218, kernel :21-69,
API include/gsdr/fm.h:42-55). The reference computes numOut+1 filtered
samples and exchanges the +1 neighbor via a warp shuffle
(src/fm.cu:58-64); with value semantics the discriminator simply consumes
consecutive filtered samples — the equivalent of the warp-overlap trick is
a 1-sample halo, which the fused FM chain kernel and the sharded layer both
honor.
"""

from gsdr_tpu.ops.fir import fir
from gsdr_tpu.ops.mixer import freq_shift
from gsdr_tpu.ops.quad_demod import quad_fm_demod

_TWO_PI = 6.283185307179586


def fm_demod_gain(rf_sample_rate, frequency_deviation):
    """Discriminator gain = Fs / (2*pi*deviation) — src/fm.cu:203."""
    return float(rf_sample_rate) / (_TWO_PI * float(frequency_deviation))


def fm_demod(
    x,
    low_pass_taps,
    rf_sample_rate,
    tuning_frequency,
    channel_frequency,
    frequency_deviation,
    decimation=1,
    first_sample_index=0,
    impl="auto",
):
    """Demodulate one FM channel out of a tuned complex RF stream.

    Returns (..., num_filtered - 1) float32 samples where
    num_filtered = (N - T)//D + 1: the discriminator consumes pairs of
    consecutive filtered samples, mirroring the reference's one-extra-sample
    contract (src/fm.cu:199). Streaming callers should overlap consecutive
    input blocks per the stream layer (gsdr_tpu.stream), which replaces the
    reference's caller-managed numLowPassTaps overlap (include/gsdr/fm.h:26).

    impl: 'auto' / 'xla' — the composed XLA chain. The fused kernel
    serves the multi-channel FmChannelizer, not this one-channel op.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"fm_demod: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    shift_hz = float(tuning_frequency) - float(channel_frequency)
    gain = fm_demod_gain(rf_sample_rate, frequency_deviation)
    mixed = freq_shift(x, shift_hz, rf_sample_rate, first_sample_index)
    filtered = fir(mixed, low_pass_taps, decimation)
    return quad_fm_demod(filtered, gain)
