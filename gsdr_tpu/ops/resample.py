"""Rational L/M polyphase resampler.

A capability the reference lacks entirely (its only rate change is integer
FIR decimation, /root/reference/src/fir.cu:50-71) but every real SDR chain
needs — e.g. FM audio at Fs/D = 250 kHz resampled to a 48 kHz sound card.

Classic polyphase form of upsample-by-L -> FIR -> downsample-by-M: with
output index j = q*L + r (r < L),

    y[j] = sum_k x[q*M + floor(r*M/L) - k] * h[(r*M) mod L + k*L]

so each of the L output phases is an ordinary stride-M FIR over the input
with its own decimated tap set — exactly the complex-tap-bank conv shape
(one conv, 2L output features, stride M; ops/channelize.py machinery),
followed by an interleave. The whole resampler is one conv.

Taps convention: ``taps`` is the prototype low-pass designed at rate
L * Fs_in with cutoff min(1/L, 1/M)/2 (pass ``design_resampler_taps`` for
a default windowed-sinc). Gain L is folded in so a DC input maps to the
same DC output.
"""

import numpy as np

import jax.numpy as jnp
from jax import lax

from gsdr_tpu.carray import ComplexArray, is_planar


def design_resampler_taps(l, m, taps_per_phase=16, window=np.hamming):
    """Windowed-sinc prototype for an L/M resampler: length L*taps_per_phase,
    cutoff min(1/L, 1/M) of the upsampled Nyquist, normalized to unit DC
    gain at the prototype rate (the upsampling gain L is applied inside
    the phase bank)."""
    l, m = int(l), int(m)
    t = l * taps_per_phase
    n = np.arange(t) - (t - 1) / 2.0
    cutoff = min(1.0 / l, 1.0 / m)
    h = np.sinc(cutoff * n) * window(t)
    return (h / h.sum()).astype(np.float32)


def _phase_bank(taps, l, m):
    """(2L, 2, Q+1) conv kernel: rows 2r/2r+1 produce re/im of phase r.

    Phase r applies (reversed-in-k) taps h[(r*M) mod L + k*L] at input
    offset floor(r*M/L) - k; we fold the offset handling into zero-padded
    rows so a single "VALID" stride-M conv over a (Qmax+1)-window computes
    every phase.
    """
    taps = np.asarray(taps, np.float64)
    l, m = int(l), int(m)
    t = len(taps)
    q_cnt = -(-t // l)  # taps per phase (max)
    # window length W covers k in [0, q_cnt-1] plus the phase offset range
    off = [int((r * m) // l) for r in range(l)]
    off0 = min(off)
    w = (q_cnt - 1) + (max(off) - off0) + 1
    kern = np.zeros((2 * l, 2, w), np.float64)
    # conv computes sum_t win[j*M + t] * K[t] over a window starting at
    # j*M + off0 - (q_cnt - 1); window position t corresponds to input
    # index j*M + off0 - (q_cnt-1) + t. Phase r needs input j*M + off[r] - k
    # weighted by h[(r*m) % l + k*l].
    for r in range(l):
        ph = (r * m) % l
        for k in range(q_cnt):
            tap_idx = ph + k * l
            if tap_idx >= t:
                continue
            pos = off[r] - k - (off0 - (q_cnt - 1))
            if not (0 <= pos < w):
                continue
            kern[2 * r, 0, pos] = taps[tap_idx]
            kern[2 * r, 1, pos] = 0.0
            kern[2 * r + 1, 1, pos] = taps[tap_idx]
    # scale by L (upsampling gain)
    kern *= l
    return kern.astype(np.float32), off0 - (q_cnt - 1), w


def _as_planar(x):
    """(planar ComplexArray, was_planar, was_complex) for any input kind."""
    if is_planar(x):
        return x, True, False
    arr = jnp.asarray(x)
    if jnp.iscomplexobj(arr):
        return ComplexArray.from_complex(arr), False, True
    return ComplexArray(arr.astype(jnp.float32),
                        jnp.zeros(arr.shape, jnp.float32)), False, False


def _resample_core(xp, kern, l, m):
    """Stride-M phase-bank conv over an already-aligned planar buffer.

    ``xp``: planar (..., N) whose position 0 is window position 0 (the
    caller handles the start/pad alignment). Returns planar
    (..., q_out * L) with q_out = (N - W)//M + 1 windows.
    """
    lead = xp.shape[:-1]
    lhs = jnp.stack([xp.re, xp.im], axis=-2).reshape((-1, 2, xp.shape[-1]))
    out = lax.conv_general_dilated(
        lhs, jnp.asarray(kern),
        window_strides=(m,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )  # (B, 2L, Q_out)
    q_out = out.shape[-1]
    out = out.reshape(lead + (l, 2, q_out))
    # interleave phases: y[q*L + r] = out[r, :, q]
    out = jnp.moveaxis(out, -1, -3)          # (..., Q_out, L, 2)
    out = out.reshape(lead + (q_out * l, 2))
    return ComplexArray(out[..., 0], out[..., 1])


class ResampleStream:
    """Stateful L/M resampler: overlap-save input tail carried across blocks.

    Feeding blocks ``x_0, x_1, ...`` produces exactly the output of
    ``resample(concat(x_i), l, m)`` split at (varying) block boundaries —
    no per-block zero-primed warmup transients and no cumulative length
    drift (each block consumes a whole number of M-strided windows; the
    remainder rides in the carried tail). Host-driven streaming: the tail
    length varies by up to M-1 samples between blocks, so this wrapper is
    for host loops (file/CLI pipelines), not for use inside jit — the conv
    itself still runs on device.
    """

    def __init__(self, l, m, taps=None, taps_per_phase=16):
        l, m = int(l), int(m)
        g = np.gcd(l, m)
        self.l, self.m = l // g, m // g
        if taps is None:
            taps = design_resampler_taps(self.l, self.m, taps_per_phase)
        self.kern, start, self.w = _phase_bank(taps, self.l, self.m)
        self._pad_l = max(0, -start)
        self._trim = max(0, start)

    def init(self, x_example):
        """Initial state: the left-padding zeros as a primed tail plus the
        number of leading input samples still to drop (one of the two is
        always zero)."""
        lead = x_example.shape[:-1] if hasattr(x_example, "shape") else ()
        tail = ComplexArray.zeros(lead + (self._pad_l,))
        return (tail, self._trim)

    def step(self, state, x):
        tail, trim = state
        xp, was_planar, was_complex = _as_planar(x)
        if trim:
            drop = min(trim, xp.shape[-1])
            xp = xp[..., drop:]
            trim -= drop
        buf = ComplexArray(
            jnp.concatenate([tail.re, xp.re], axis=-1),
            jnp.concatenate([tail.im, xp.im], axis=-1),
        )
        n = buf.shape[-1]
        q = (n - self.w) // self.m + 1 if n >= self.w else 0
        if q <= 0:
            empty = ComplexArray.zeros(buf.shape[:-1] + (0,))
            out = empty
            new_tail = buf
        else:
            out = _resample_core(
                buf[..., : (q - 1) * self.m + self.w], self.kern,
                self.l, self.m)
            new_tail = buf[..., q * self.m:]
        if not was_planar:
            out = out.to_complex() if was_complex else out.re
        return (new_tail, trim), out


def resample(x, l, m, taps=None, taps_per_phase=16):
    """Resample planar/real (..., N) by rational factor L/M.

    Returns (..., floor((N - warmup) * L / M)) samples at rate Fs*L/M,
    delayed by the filter group delay. The trailing ``warmup`` (the
    filter-window remainder, up to W-1 < taps_per_phase + M samples) is
    NOT emitted — it belongs to windows that also need the next block;
    use ResampleStream to carry it across blocks instead of dropping it.
    ``taps``: prototype at rate L*Fs (default windowed-sinc via
    design_resampler_taps).
    """
    l, m = int(l), int(m)
    if l < 1 or m < 1:
        raise ValueError(f"L and M must be >= 1, got {l}/{m}")
    g = np.gcd(l, m)
    l, m = l // g, m // g
    if taps is None:
        t = l * taps_per_phase
        n_ = np.arange(t) - (t - 1) / 2.0
        cutoff = min(1.0 / l, 1.0 / m)
        h = np.sinc(cutoff * n_) * np.hamming(t)
        taps = (h / h.sum()).astype(np.float32)

    xp, was_planar, was_complex = _as_planar(x)
    kern, start, w = _phase_bank(taps, l, m)
    # shift input so window position 0 aligns with start (pad left if
    # start < 0; trim if > 0)
    pad_l = max(0, -start)
    trim = max(0, start)
    re = jnp.pad(xp.re, [(0, 0)] * (xp.ndim - 1) + [(pad_l, 0)])[..., trim:]
    im = jnp.pad(xp.im, [(0, 0)] * (xp.ndim - 1) + [(pad_l, 0)])[..., trim:]
    res = _resample_core(ComplexArray(re, im), kern, l, m)
    if was_planar:
        return res
    return res.to_complex() if was_complex else res.re
