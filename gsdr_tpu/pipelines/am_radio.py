"""Multi-channel AM receiver pipeline.

The streaming, multi-channel form of gsdrAmDemod
(/root/reference/src/am.cu:52-81): fused complex-tap-bank channelize
(mix + FIR low-pass + decimate in one conv, gsdr_tpu.ops.channelize) ->
envelope detector. Same skeleton as the FM channelizer minus the
discriminator halo (the AM chain has no neighbor-sample dependency,
src/am.cu:21-50), so state is just (global offset, raw RF tail).
"""

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, is_planar
from gsdr_tpu.ops.channelize import make_complex_tap_bank, mix_fir_decimate_bank
from gsdr_tpu.ops.quad_demod import quad_am_demod


@dataclass(frozen=True)
class AmReceiver:
    """C-channel AM envelope receiver with functional streaming state.

    ``step(state, rf_block)`` maps a planar (N,) RF block (N % decimation
    == 0) to (state', audio (C, N/decimation) float32 in [-1, 1]). State:
    (n0_mod_fs int32, rf_tail ComplexArray (T-1,)).
    """

    sample_rate: float
    tuning_frequency: float
    channel_frequencies: Tuple[float, ...]
    decimation: int
    low_pass_taps: Tuple[float, ...]
    # 'auto' / 'xla': the dense tap bank (XLA) | 'pfb': the XLA polyphase
    # front (uniform Fs/K channel grid with D | K, ops/pfb.py). No kernel
    # serves the AM chain.
    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in ("auto", "xla", "pfb"):
            raise ValueError(f"AmReceiver: unknown impl {self.impl!r} "
                             "(expected 'auto', 'xla' or 'pfb')")

    @property
    def num_channels(self):
        return len(self.channel_frequencies)

    @property
    def num_taps(self):
        return len(self.low_pass_taps)

    def _shifts(self):
        return [
            float(self.tuning_frequency) - float(f)
            for f in self.channel_frequencies
        ]

    def _tap_bank(self):
        return make_complex_tap_bank(
            self.low_pass_taps, self._shifts(), self.sample_rate)

    def _pfb_grid(self):
        from gsdr_tpu.ops.pfb import decimating_grid

        return decimating_grid(self._shifts(), self.sample_rate,
                               self.decimation)

    def init(self, first_sample_index=0):
        fs = int(round(self.sample_rate))
        return (
            jnp.asarray(int(first_sample_index) % fs, jnp.int32),
            ComplexArray.zeros((self.num_taps - 1,)),
        )

    def step(self, state, rf):
        if not is_planar(rf):
            rf = ComplexArray.from_complex(jnp.asarray(rf))
        n0, rf_tail = state
        n = rf.shape[-1]
        t = self.num_taps
        fs = int(round(self.sample_rate))
        if n % self.decimation != 0:
            raise ValueError("block length must be a multiple of decimation")

        buf = ComplexArray(
            jnp.concatenate([rf_tail.re, rf.re], axis=-1),
            jnp.concatenate([rf_tail.im, rf.im], axis=-1),
        )
        if self.impl == "pfb":
            from gsdr_tpu.ops.pfb import mix_fir_decimate_bank_uniform

            k_grid, bins = self._pfb_grid()
            y = mix_fir_decimate_bank_uniform(
                buf, self.low_pass_taps, bins, k_grid, self.decimation)
        else:
            y = mix_fir_decimate_bank(buf, self._tap_bank(), self.decimation)
        new_tail = buf[..., buf.shape[-1] - (t - 1):]

        # The envelope |y_rot| = |y|: the LO rotor cancels, so the
        # un-rotated bank output feeds it directly (src/am.cu:49).
        audio = quad_am_demod(y)
        n0_new = (n0 + jnp.int32(n % fs)) % fs
        return (n0_new, new_tail), audio
