"""Functional streaming layer: explicit (state, block) -> (state, out).

The reference makes streaming the *caller's* problem: consecutive calls must
overlap inputs by numLowPassTaps samples (/root/reference/include/gsdr/
fm.h:26), oscillator phase continuity rides on a firstSampleIndex argument
(src/adjustFrequency.cuh:25), and the IIR history pointers are accepted but
ignored (include/gsdr/iir.h:74-75). This module replaces all three contracts
with explicit, jittable state pytrees:

  * every streaming op is a pure function ``step(state, block) -> (state,
    out)`` with static shapes — jit/scan/shard_map friendly;
  * the state pytree IS the checkpoint object: save/restore it (e.g. with
    orbax) and the stream resumes bit-exactly;
  * blocks prime with zeros, so the first ~ceil((T-1)/D) outputs of a
    filtered stream are a warmup transient (reported by each op's
    ``warmup_outputs``) — the standard overlap-save convention, instead of
    the reference's "caller supplies history" convention.

Block-length contract: filtered streams require ``block_len % decimation ==
0`` so every block yields exactly block_len/decimation outputs and the
carried tail keeps a static shape.
"""

from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from gsdr_tpu.carray import ComplexArray, expj, is_planar
from gsdr_tpu.ops.fir import fir
from gsdr_tpu.ops.iir import iir_block, _normalize_coeffs
from gsdr_tpu.ops.quad_demod import quad_am_demod, quad_fm_demod
from gsdr_tpu.utils.phase import phase_digit_table, phase_fraction_from_table

_TWO_PI = 6.283185307179586


def _concat_last(a, b):
    if is_planar(a) or is_planar(b):
        return ComplexArray(
            jnp.concatenate([a.re, b.re], axis=-1),
            jnp.concatenate([a.im, b.im], axis=-1),
        )
    return jnp.concatenate([a, b], axis=-1)


def _zeros_like_block(x, shape):
    if is_planar(x):
        return ComplexArray(
            jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
        )
    return jnp.zeros(shape, jnp.asarray(x).dtype)


# ---------------------------------------------------------------------------
# Mixer / LO stream
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MixerStream:
    """Streaming frequency shift by ``freq_shift_hz`` with exact phase
    continuity.

    State is the global sample offset reduced mod the LO's true period
    (int32) — the functional form of the reference's
    firstSampleIndex-mod-Fs contract (src/am.cu:67), carried by the
    framework instead of the caller, and made EXACT for any rational
    f/Fs ratio: the wrap modulus is round(Fs) when the phase is periodic
    there (integral shifts at integral rates — the common case), else the
    exact period q of frac(f*n/Fs) (f/Fs = p/q reduced over the floats'
    exact binary values) when q fits an int32 index budget. A ratio whose
    reduced denominator exceeds 2^24 (e.g. freq_shift_hz=0.1 — the float
    0.1 is not 1/10) has no representable period; construction WARNS and
    the LO phase then jumps by frac(f*round(Fs)/Fs) cycles every round(Fs)
    samples — quantize such shifts to 1 Hz or pick an exactly
    representable ratio (0.125 Hz, 1/2^k multiples, ...).
    """

    freq_shift_hz: float
    sample_rate: float

    # q above this has no headroom under the int32 digit-table index
    # budget (state + block must stay < 2^31)
    _MAX_PERIOD = 1 << 24

    def __post_init__(self):
        if not self._wrap_is_exact():
            import warnings
            warnings.warn(
                f"MixerStream(freq_shift_hz={self.freq_shift_hz}, "
                f"sample_rate={self.sample_rate}): neither round(Fs) nor "
                f"any period <= {self._MAX_PERIOD} samples is an exact "
                "period of frac(f*n/Fs), so streaming phase continuity "
                "is APPROXIMATE (a frac-cycle LO jump at each state "
                "wrap). Quantize the shift to an exactly representable "
                "ratio (integral Hz at integral Fs, or 1/2^k Hz "
                "multiples).",
                stacklevel=3)

    def _ratio(self):
        from fractions import Fraction

        fs = Fraction(float(self.sample_rate))
        if fs <= 0:
            return None
        return Fraction(float(self.freq_shift_hz)) / fs

    def _wrap_is_exact(self):
        """True when _wrap_modulus() is a true period of frac(f*n/Fs) —
        round(Fs) counts even when the reduced denominator q exceeds the
        index budget (e.g. any integral shift at an integral Fs > 2^24:
        q = Fs/gcd may be huge, but f*round(Fs)/Fs is still integral)."""
        ratio = self._ratio()
        if ratio is None:
            return False
        m = max(1, int(round(self.sample_rate)))
        return (ratio * m).denominator == 1 \
            or ratio.denominator <= self._MAX_PERIOD

    def _wrap_modulus(self):
        m = max(1, int(round(self.sample_rate)))
        ratio = self._ratio()
        if ratio is None:
            return m
        # keep the historical mod-Fs state whenever it is already exact
        if (ratio * m).denominator == 1:
            return m
        q = ratio.denominator
        if q <= self._MAX_PERIOD:
            return q  # exact true period
        return m  # approximate legacy behavior (warned at construction)

    def _table(self):
        return phase_digit_table([self.freq_shift_hz], self.sample_rate)[0]

    def init(self, first_sample_index=0):
        n0 = int(first_sample_index) % self._wrap_modulus()
        return jnp.asarray(n0, jnp.int32)

    def step(self, state, x):
        n = x.shape[-1]
        idx = state + jnp.arange(n, dtype=jnp.int32)
        frac = phase_fraction_from_table(idx, jnp.asarray(self._table()))
        lo = expj(_TWO_PI * frac)
        m = self._wrap_modulus()
        new_state = (state + jnp.int32(n % m)) % m
        if is_planar(x):
            return new_state, x * lo
        return new_state, jnp.asarray(x) * lo.to_complex()


# ---------------------------------------------------------------------------
# FIR stream (overlap-save with fixed T-1 tail)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FirStream:
    """Streaming FIR + decimation with a carried (T-1)-sample input tail.

    With tail length fixed at T-1 and block_len % D == 0, every block
    produces exactly block_len/D outputs and the carried tail keeps its
    shape: (T-1 + L - T)//D + 1 == L/D outputs consume exactly L samples.
    This replaces the reference's caller-managed numLowPassTaps overlap
    (include/gsdr/fm.h:26) and keeps decimation phase aligned across blocks
    (the grid i*D of src/fir.cu:58 continues seamlessly).
    """

    taps: tuple
    decimation: int = 1

    @property
    def num_taps(self):
        return len(self.taps)

    @property
    def warmup_outputs(self):
        """Leading outputs polluted by the zero-primed tail."""
        return -(-(self.num_taps - 1) // self.decimation)

    def init(self, x_example):
        lead = x_example.shape[:-1]
        return _zeros_like_block(x_example, lead + (self.num_taps - 1,))

    def step(self, state, x):
        if x.shape[-1] % self.decimation != 0:
            raise ValueError("block_len must be a multiple of decimation")
        buf = _concat_last(state, x)
        y = fir(buf, jnp.asarray(self.taps, jnp.float32), self.decimation)
        tail = buf[..., buf.shape[-1] - (self.num_taps - 1):] \
            if self.num_taps > 1 else self.init(x)
        return tail, y


# ---------------------------------------------------------------------------
# IIR stream
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IirStream:
    """Streaming exact IIR: the transposed-DF-II state vector IS the carry.

    The reference accepts history pointers and ignores them
    (include/gsdr/iir.h:74-75); here the state actually works, and the
    blocked-scan kernel (gsdr_tpu.ops.iir) keeps each block exact."""

    b: tuple
    a: tuple
    block_len: int = 128

    def init(self, x_example):
        lead = x_example.shape[:-1]
        m = len(self.b) - 1
        return _zeros_like_block(x_example, lead + (m,))

    def step(self, state, x):
        b = jnp.asarray(self.b, jnp.float32)
        a = jnp.asarray(self.a, jnp.float32)
        y, zf = iir_block(b, a, x, zi=state, block_len=self.block_len)
        return zf, y


@dataclass(frozen=True)
class SosStream:
    """Streaming cascade of second-order sections.

    State stacks each section's transposed-DF-II state on a leading axis
    (shape (S,) + batch + (2,)); block-split output equals single-shot
    iir_sos exactly, like IirStream but numerically robust at high order."""

    sos: tuple  # ((b0, b1, b2, a0, a1, a2), ...) rows
    block_len: int = 128

    def init(self, x_example):
        lead = x_example.shape[:-1]
        return _zeros_like_block(
            x_example, (len(self.sos),) + lead + (2,))

    def step(self, state, x):
        from gsdr_tpu.ops.iir import iir_sos_block

        sos = jnp.asarray(self.sos, jnp.float32)
        y, zf = iir_sos_block(sos, x, zi=state, block_len=self.block_len)
        return zf, y


# ---------------------------------------------------------------------------
# Quadrature FM discriminator stream (one-sample halo carry)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuadFmStream:
    """Streaming FM discriminator: carries the previous block's last sample.

    The reference's warp-shuffle +1-sample trick (src/fm.cu:58-64) and its
    numOut+1 input contract (src/fm.cu:199) become a one-sample carried halo:
    each block of N filtered samples yields N outputs (the first consumes the
    carried sample). The very first output is a warmup artifact (carry primes
    at zero -> atan2(0,0) = 0 exactly, so output[0] = 0)."""

    gain: float

    warmup_outputs = 1

    def init(self, x_example):
        lead = x_example.shape[:-1]
        return _zeros_like_block(x_example, lead + (1,))

    def step(self, state, x):
        buf = _concat_last(state, x)
        y = quad_fm_demod(buf, self.gain)
        return buf[..., buf.shape[-1] - 1:], y


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Chain:
    """Compose streaming ops into one (state-tuple, block) -> step.

    The composed step is pure and jittable; the state tuple is the
    checkpoint/resume object for the whole pipeline (SURVEY.md section 5:
    this replaces the reference's caller-carried overlap + firstSampleIndex +
    ignored-history contracts with one functional object)."""

    stages: Sequence

    def init(self, x_example, first_sample_index=0):
        states = []
        cur = x_example
        for s in self.stages:
            if isinstance(s, MixerStream):
                states.append(s.init(first_sample_index))
            else:
                states.append(s.init(cur))
            _, cur = s.step(states[-1], cur)
        return tuple(states)

    def step(self, states, x):
        new_states = []
        cur = x
        for s, st in zip(self.stages, states):
            st2, cur = s.step(st, cur)
            new_states.append(st2)
        return tuple(new_states), cur


def run_stream(chain, states, blocks):
    """Convenience driver: apply ``chain`` over a Python list of blocks."""
    outs = []
    for blk in blocks:
        states, y = chain.step(states, blk)
        outs.append(y)
    return states, outs


def scan_stream(step, state, blocks):
    """Run ``step`` over a leading block axis inside ONE jitted lax.scan.

    ``blocks``: array/pytree shaped (num_blocks, ...block_shape) — e.g.
    reshape a long planar capture into (B, L) with
    ``ComplexArray(re.reshape(B, L), im.reshape(B, L))``. Returns
    (final_state, outs) with outs stacked on the leading axis.

    This is the high-throughput path for a capture already in memory:
    one dispatch per capture instead of one per block. The functional
    state threading is what makes this possible — the reference's
    caller-managed-pointer contracts cannot be scanned.
    """
    import jax
    from jax import lax

    def body(st, blk):
        st, out = step(st, blk)
        return st, out

    return lax.scan(body, state, blocks)
