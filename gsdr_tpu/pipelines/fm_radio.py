"""Multi-channel FM broadcast receiver (channelizer) — the flagship model.

One wideband complex RF stream in; C demodulated (and de-emphasized) audio
channels out. This is the chain the reference fuses in gsdrFmDemod
(/root/reference/src/fm.cu:181-218) — mix -> FIR low-pass + decimate ->
quadrature discriminator — extended the way its dead 4-channel kernel
k_Fm4x intended (src/fm.cu:71-179, never launched): instead of 4 hand-written
LO/accumulator copies, the channel bank is a complex-tap conv
(gsdr_tpu.ops.channelize) that computes ALL channels' mix+FIR+decimate as a
single convolution over the raw RF block; the discriminator needs only one
constant phasor per channel in place of the LO. Added on top: IIR de-emphasis
per channel (the reference ships IIR but never wires it into the chain) and
an explicit streaming-state pytree (replacing the caller-managed
overlap/phase contracts, include/gsdr/fm.h:26).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, is_planar
from gsdr_tpu.ops.channelize import (
    discriminator_carry,
    discriminator_prev,
    fm_discriminate_bank,
    make_complex_tap_bank,
    mix_fir_decimate_bank,
)
from gsdr_tpu.ops.iir import iir_block
from gsdr_tpu.utils.phase import phase_digit_table

_TWO_PI = 6.283185307179586


def fm_deemphasis_coeffs(tau_seconds, sample_rate):
    """First-order de-emphasis IIR (b, a) via bilinear transform of
    H(s)=1/(1+s*tau). tau = 75e-6 (US) / 50e-6 (EU); sample_rate is the
    post-decimation audio rate.

    Raises when the prewarp argument 1/(2*tau*fs) reaches pi/2 — past it
    tan() flips sign and the mapped pole leaves the unit circle, i.e.
    the discrete filter is UNSTABLE (hit in round 5 at a 4-kHz audio
    rate with the US 75-us tau: outputs diverge to ~1e21). The validity
    condition is tau > 1/(pi * audio_rate). A tau <= 0 has no filter
    behind it (zero divides by zero; a negative tau puts the pole outside
    the unit circle) and raises too."""
    if not float(tau_seconds) > 0.0:
        raise ValueError(
            f"de-emphasis tau must be positive, got {tau_seconds}")
    arg = 1.0 / (2.0 * float(tau_seconds) * float(sample_rate))
    if arg >= math.pi / 2.0:
        raise ValueError(
            f"de-emphasis tau={tau_seconds} is below the bilinear "
            f"validity limit 1/(pi*audio_rate) = "
            f"{1.0 / (math.pi * float(sample_rate)):.3g} s at audio rate "
            f"{sample_rate:.6g} Hz — the mapped pole is unstable. Use a "
            "larger tau or a higher post-decimation audio rate.")
    k = math.tan(arg)
    b0 = k / (1.0 + k)
    a1 = (k - 1.0) / (k + 1.0)
    return (b0, b0), (1.0, a1)


@dataclass(frozen=True)
class FmChannelizer:
    """C-channel FM receiver: complex-tap-bank channelize -> discriminator
    -> de-emphasis.

    Config is static (hashable); state is a pytree:
      (n0_mod_fs: int32 scalar — global offset of the next block,
       rf_tail: ComplexArray (T-1,) — raw RF overlap-save history,
       disc_carry: ComplexArray (C, 1) — last filtered sample,
       deemph_zi: float32 (C, 1))

    ``step(state, rf_block)`` takes a planar (N,) RF block (N % decimation
    == 0) and returns (state', audio (C, N/decimation) float32).

    Phase continuity assumes integral sample_rate and integral channel
    offsets (tuning - channel): n0 is reduced mod round(Fs), which is exact
    only when frac(f*Fs/Fs) == 0 for every shift f (see MixerStream).
    Non-integral offsets incur a frac(f)-cycle LO jump every Fs samples;
    quantize offsets to 1 Hz to avoid it.
    """

    sample_rate: float
    tuning_frequency: float
    channel_frequencies: Tuple[float, ...]
    frequency_deviation: float
    decimation: int
    low_pass_taps: Tuple[float, ...]
    deemphasis_tau: float = 75e-6
    # 'auto': the fused kernel (kernels/fm_chain_triton.py) on a GPU when
    # it supports the shape, else the XLA chain | 'xla' | 'pallas': the
    # fused kernel, or ValueError where it cannot run | 'pfb': the XLA
    # polyphase front (uniform Fs/K channel grid with D | K, ops/pfb.py)
    impl: str = "auto"
    # impl='pallas' only: run the kernel in the Pallas interpreter (CPU)
    interpret: bool = False

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"FmChannelizer: unknown impl {self.impl!r} "
                             f"(expected one of {_IMPLS})")

    # -- derived (host-side) -------------------------------------------------
    @property
    def num_channels(self):
        return len(self.channel_frequencies)

    @property
    def num_taps(self):
        return len(self.low_pass_taps)

    @property
    def gain(self):
        """Discriminator gain Fs/(2*pi*deviation) — src/fm.cu:203."""
        return float(self.sample_rate) / (_TWO_PI * float(self.frequency_deviation))

    @property
    def audio_rate(self):
        return float(self.sample_rate) / self.decimation

    def _shifts(self):
        """shift = tuning - channel (src/fm.cu:204): each channel mixes down
        by its offset from center."""
        return [
            float(self.tuning_frequency) - float(f)
            for f in self.channel_frequencies
        ]

    def _lo_table(self):
        return phase_digit_table(self._shifts(), self.sample_rate)

    def _tap_bank(self):
        return make_complex_tap_bank(
            self.low_pass_taps, self._shifts(), self.sample_rate)

    def _deemph(self):
        return fm_deemphasis_coeffs(self.deemphasis_tau, self.audio_rate)

    def _pfb_grid(self):
        from gsdr_tpu.ops.pfb import decimating_grid

        return decimating_grid(self._shifts(), self.sample_rate,
                               self.decimation)

    def uses_kernel(self):
        """True when step() runs the fused kernel (the dispatch rule of
        gsdr_tpu.backend.use_kernel; raises where impl='pallas' cannot
        run)."""
        from gsdr_tpu.backend import use_kernel
        from gsdr_tpu.kernels.fm_chain_triton import fm_chain_supported

        return use_kernel(
            self.impl, fm_chain_supported(self.num_taps, self.num_channels),
            self.interpret, what="fused FM chain kernel")

    # -- state ----------------------------------------------------------------
    def init(self, first_sample_index=0):
        c, t = self.num_channels, self.num_taps
        fs = int(round(self.sample_rate))
        return (
            jnp.asarray(int(first_sample_index) % fs, jnp.int32),
            ComplexArray.zeros((t - 1,)),
            ComplexArray.zeros((c, 1)),
            jnp.zeros((c, 1), jnp.float32),
        )

    # -- one streaming step (pure; jit this) ----------------------------------
    def step(self, state, rf):
        if not is_planar(rf):
            rf = ComplexArray.from_complex(jnp.asarray(rf))
        n0, rf_tail, disc_carry, deemph_zi = state
        n = rf.shape[-1]
        t = self.num_taps
        d = self.decimation
        fs = int(round(self.sample_rate))
        if n % d != 0:
            raise ValueError("block length must be a multiple of decimation")

        # Window j of the tail-prepended block starts at global index
        # n0 - (T-1) + j*D; rot0 is that index for j = 0, mod Fs.
        buf = ComplexArray(
            jnp.concatenate([rf_tail.re, rf.re], axis=-1),
            jnp.concatenate([rf_tail.im, rf.im], axis=-1),
        )
        new_tail = buf[..., buf.shape[-1] - (t - 1):]
        n0_new = (n0 + jnp.int32(n % fs)) % fs
        rot0 = (n0 + jnp.int32(fs - (t - 1) % fs)) % fs
        rot0_next = (n0_new + jnp.int32(fs - (t - 1) % fs)) % fs
        table = self._lo_table()
        b, a = self._deemph()

        if self.uses_kernel():
            # one fused kernel: bank, discriminator and de-emphasis
            from gsdr_tpu.kernels.fm_chain_triton import fm_chain

            audio, y_last, new_zi = fm_chain(
                buf, self._tap_bank(), table, rot0, d, self.gain, b, a,
                disc_carry, deemph_zi, interpret=self.interpret)
            new_carry = discriminator_carry(y_last, table, rot0_next, d)
            return (n0_new, new_tail, new_carry, new_zi), audio

        # 1+2) mix bank + FIR + decimate, un-rotated (C, N/D)
        if self.impl == "pfb":
            from gsdr_tpu.ops.pfb import mix_fir_decimate_bank_uniform

            k_grid, bins = self._pfb_grid()
            y = mix_fir_decimate_bank_uniform(
                buf, self.low_pass_taps, bins, k_grid, d)
        else:
            y = mix_fir_decimate_bank(buf, self._tap_bank(), d)

        # 3) discriminator with the one-sample carried halo (the
        # warp-shuffle +1-sample contract, src/fm.cu:58-64, as state)
        prev = discriminator_prev(disc_carry, table, rot0, d)
        demod = fm_discriminate_bank(y, prev, table, d, self.gain)
        new_carry = discriminator_carry(y[..., y.shape[-1] - 1:], table,
                                        rot0_next, d)

        # 4) de-emphasis IIR, exact blocked scan with carried state.
        audio, new_zi = iir_block(
            np.asarray(b, np.float32), np.asarray(a, np.float32),
            demod, zi=deemph_zi, block_len=256,
        )
        return (n0_new, new_tail, new_carry, new_zi), audio


_IMPLS = ("auto", "xla", "pallas", "pfb")
