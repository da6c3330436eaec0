"""gsdr_tpu — a software-defined-radio DSP framework in JAX, for the GPU.

A brand-new JAX/XLA/Pallas framework with the full capability surface of the
CUDA library kernrj/gsdr (see SURVEY.md): arithmetic / conversion / trig
primitives, frequency shifting (mixing), FIR filtering with decimation, exact
IIR filtering, AM envelope and quadrature-FM demodulation (standalone and as
fused chains), and QPSK / 256-ary QPSK modems — plus layers the single-GPU
reference never had: an explicit functional streaming-state layer, and a
sharding layer that scales channels and time-blocks across device meshes
with halo-exchange collectives.

Conventions (replacing the reference's C ABI, include/gsdr/gsdr.h:19-30):
  * Ops are pure jittable functions operating on the LAST axis; any leading
    axes are batch/channel axes. This replaces the reference's 2x/4x/8x
    multi-stream pointer APIs (src/qpsk.cu:148-219) with a channel axis.
  * Complex data is complex64 at the API boundary; models, kernels and the
    sharded layer use split re/im float32 (gsdr_tpu.carray).
  * Streaming state (filter tails, oscillator phase, IIR state) is an
    explicit functional carry — see gsdr_tpu.stream — replacing the
    reference's caller-managed overlap / firstSampleIndex contracts
    (include/gsdr/fm.h:26, src/adjustFrequency.cuh:25).
"""

from gsdr_tpu.carray import ComplexArray, as_planar, expj
from gsdr_tpu.ops.arithmetic import (
    add_const,
    add_to_magnitude,
    absolute,
    magnitude,
    multiply,
)
from gsdr_tpu.ops.conversion import int8_to_norm_float
from gsdr_tpu.ops.trig import cosine_c, cosine_f
from gsdr_tpu.ops.fir import fir, fir_output_length
from gsdr_tpu.ops.mixer import freq_shift, lo_signal
from gsdr_tpu.ops.quad_demod import quad_am_demod, quad_fm_demod
from gsdr_tpu.ops.am import am_demod
from gsdr_tpu.ops.fm import fm_demod, fm_demod_gain
from gsdr_tpu.ops.iir import (
    iir,
    iir_block,
    iir_reference,
    iir_sos,
    iir_sos_block,
)
from gsdr_tpu.ops.qpsk import (
    qpsk_constellation,
    qpsk_demodulate,
    qpsk_modulate,
    qpsk_modulate_symbols,
    pack_2bit_symbols,
    unpack_2bit_symbols,
)
from gsdr_tpu.ops.channelize import channelize, make_complex_tap_bank
from gsdr_tpu.ops.pfb import pfb_channelize
from gsdr_tpu.ops.resample import (
    ResampleStream,
    design_resampler_taps,
    resample,
)
from gsdr_tpu.ops.qpsk256 import (
    qpsk256_constellation,
    qpsk256_demodulate,
    qpsk256_demodulate_circular,
    qpsk256_demodulate_rect,
    qpsk256_modulate,
    qpsk256_modulate_circular,
    qpsk256_modulate_rect,
)

__version__ = "0.1.0"

__all__ = [
    "ComplexArray",
    "as_planar",
    "expj",
    "add_const",
    "add_to_magnitude",
    "absolute",
    "magnitude",
    "multiply",
    "int8_to_norm_float",
    "cosine_c",
    "cosine_f",
    "fir",
    "fir_output_length",
    "channelize",
    "make_complex_tap_bank",
    "pfb_channelize",
    "resample",
    "ResampleStream",
    "design_resampler_taps",
    "freq_shift",
    "lo_signal",
    "quad_am_demod",
    "quad_fm_demod",
    "am_demod",
    "fm_demod",
    "fm_demod_gain",
    "iir",
    "iir_block",
    "iir_reference",
    "iir_sos",
    "iir_sos_block",
    "qpsk_constellation",
    "qpsk_modulate",
    "qpsk_modulate_symbols",
    "qpsk_demodulate",
    "pack_2bit_symbols",
    "unpack_2bit_symbols",
    "qpsk256_constellation",
    "qpsk256_modulate",
    "qpsk256_modulate_rect",
    "qpsk256_modulate_circular",
    "qpsk256_demodulate",
    "qpsk256_demodulate_rect",
    "qpsk256_demodulate_circular",
]
