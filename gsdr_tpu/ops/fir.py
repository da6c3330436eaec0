"""FIR filtering with decimation.

Capability parity with gsdrFirFC/FF/CC/CF (/root/reference/include/gsdr/
fir.h:30-68, kernels src/fir.cu:27-71). Reference contract, kept exactly:

    out[i] = sum_{t=0}^{T-1} x[i*D + t] * taps[t]

i.e. a "valid"-mode cross-correlation with caller-supplied taps (the
reference documents taps as pre-reversed, making this a convolution with the
designer's impulse response); the caller supplies (numOutputs-1)*D + T input
samples and no normalization is applied. The four dtype combos collapse into
one polymorphic function; the thread-per-output CUDA grid becomes
lax.conv_general_dilated (cuDNN on the GPU). Complex data runs as split
re/im real convolutions, the planar layout of gsdr_tpu.carray.
"""

import jax.numpy as jnp
from jax import lax

from gsdr_tpu.carray import ComplexArray, is_planar


def fir_output_length(num_inputs, num_taps, decimation=1):
    """Number of outputs producible from ``num_inputs`` samples."""
    if num_inputs < num_taps:
        return 0
    return (num_inputs - num_taps) // decimation + 1


def _real_conv(x, taps, decimation):
    """Batched valid cross-correlation of real 2D x (B, N) with taps (T,)."""
    lhs = x[:, None, :]  # (B, C=1, N)
    rhs = taps[None, None, :]  # (O=1, I=1, T)
    out = lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(decimation,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def _batched(x):
    """Flatten leading axes; returns (x2d, restore_fn)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    return x.reshape((-1, n)), lambda o: o.reshape(lead + (o.shape[-1],))


def fir_planar(x, taps, decimation=1):
    """FIR core on a planar ComplexArray with real or planar taps."""
    re2, restore = _batched(x.re)
    im2, _ = _batched(x.im)
    b = re2.shape[0]
    stacked = jnp.concatenate([re2, im2], axis=0)
    if is_planar(taps):
        with_r = _real_conv(stacked, taps.re.astype(jnp.float32), decimation)
        with_i = _real_conv(stacked, taps.im.astype(jnp.float32), decimation)
        out_re = with_r[:b] - with_i[b:]
        out_im = with_r[b:] + with_i[:b]
    else:
        t = jnp.asarray(taps, dtype=jnp.float32)
        res = _real_conv(stacked, t, decimation)
        out_re, out_im = res[:b], res[b:]
    return ComplexArray(restore(out_re), restore(out_im))


def fir(x, taps, decimation=1):
    """Apply a FIR filter with optional decimation along the last axis.

    Args:
      x: input samples: real array, complex64 array, or ComplexArray,
        shape (..., N).
      taps: filter taps, real / complex64 / ComplexArray, shape (T,). Applied
        as written (cross-correlation) — pass reversed taps for true
        convolution, matching the reference's pre-reversed-taps contract
        (src/fir.cu:57-70).
      decimation: output stride D >= 1 (src/fir.cu:50-71).

    Returns:
      (..., (N - T)//D + 1) filtered samples in the representation of ``x``
      (covers the reference's FF/FC/CC/CF combos).
    """
    decimation = int(decimation)
    if decimation < 1:
        raise ValueError("decimation must be >= 1")
    tap_len = taps.shape[0] if is_planar(taps) else jnp.asarray(taps).shape[-1]
    n = x.shape[-1]
    if n < tap_len:
        raise ValueError(f"need at least {tap_len} input samples, got {n}")

    if is_planar(x):
        return fir_planar(x, taps, decimation)

    x = jnp.asarray(x)
    taps_cplx = (not is_planar(taps)) and jnp.iscomplexobj(jnp.asarray(taps))
    if jnp.iscomplexobj(x) or is_planar(taps) or taps_cplx:
        tp = taps if is_planar(taps) else (
            ComplexArray.from_complex(jnp.asarray(taps)) if taps_cplx
            else jnp.asarray(taps)
        )
        xp = ComplexArray.from_complex(x) if jnp.iscomplexobj(x) else \
            ComplexArray(x.astype(jnp.float32), jnp.zeros(x.shape, jnp.float32))
        out = fir_planar(xp, tp, decimation)
        return out.to_complex()

    x2, restore = _batched(x.astype(jnp.float32))
    out = _real_conv(x2, jnp.asarray(taps, jnp.float32), decimation)
    return restore(out)
