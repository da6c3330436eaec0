"""IIR filtering as an exact blocked parallel scan.

Capability parity with gsdrIirFF/CC and the *Custom variants
(/root/reference/src/iir.cu:341-394,499-533; API include/gsdr/iir.h:87-191).
Semantics are scipy-style Direct Form: with a[0] = 1,

    y[n] = sum_i b[i] x[n-i] - sum_{i>=1} a[i] y[n-i]

matching the reference recurrence (src/iir.cu:158-178). The reference
*approximates* this: each CUDA thread owns 8-32 consecutive samples with
zero-initialized private history, so filter state resets every chunk
(src/iir.cu:118-127 — SURVEY.md section 2.2 caveat 5). This implementation
is EXACT while still parallel, via the state-space block decomposition:

Transposed Direct Form II state z in R^m (m = order = coeff_count - 1):

    y[n]   = b0 x[n] + z[n-1][0]
    z[n]   = M z[n-1] + c x[n]

with M[i,0] = -a[i+1], M[i,i+1] = 1, and c[i] = b[i+1] - a[i+1] b0 — a
*linear* recurrence, so it block-decomposes exactly:

  1. zero-state pass: split x into B blocks of L; every block's response
     from z = 0 is one (B, L) x (L, L) matmul with the lower-triangular
     impulse-response matrix, and its end state one (B, L) x (L, m) matmul
     (no per-sample loop, which on a GPU would be L sequential launches);
  2. cross-block combine: true block-start states follow the affine
     recurrence Z[b+1] = M^L Z[b] + d[b]; composed with
     lax.associative_scan in log2(B) steps;
  3. correction: the initial-state contribution to in-block outputs is
     Z_start @ K^T with K[t] = e0^T M^t — one (B, m) x (m, L) matmul.

The reference's `samplesPerThread` tuning knob (include/gsdr/iir.h:158)
becomes ``block_len``. Numerical note: M^t decays for stable filters, so the
f32 composition is well-conditioned; for high orders prefer iir_sos
(cascaded biquads), the standard conditioning fix the reference lacks.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_MIN_COEFFS = 2
_MAX_COEFFS = 32  # reference validation range, src/iir.cu:243-249


def _normalize_coeffs(b, a, dtype):
    b = jnp.asarray(b, dtype=dtype)
    a = jnp.asarray(a, dtype=dtype)
    if b.ndim != 1 or a.ndim != 1 or b.shape[0] != a.shape[0]:
        raise ValueError("b and a must be 1-D with equal length (reference "
                         "coeffCount contract, include/gsdr/iir.h:99)")
    nc = b.shape[0]
    if not (_MIN_COEFFS <= nc <= _MAX_COEFFS):
        raise ValueError(f"coeff count must be in [{_MIN_COEFFS}, {_MAX_COEFFS}], got {nc}")
    b = b / a[0]
    a = a / a[0]
    return b, a


def _state_space(b, a):
    """(M, c, b0) for the transposed DF-II recurrence above."""
    m = b.shape[0] - 1
    b0 = b[0]
    col = -a[1:]
    shift = jnp.eye(m, k=1, dtype=b.dtype)
    M = shift.at[:, 0].add(col)
    c = b[1:] - a[1:] * b0
    return M, c, b0


def _powers(M, c, L):
    """Tables for block length L: K (L, m) with K[t] = e0^T M^t, V (L, m)
    with V[t] = M^t c, and M^L (m, m). Sequential products, the
    well-conditioned order for high-order filters (repeated squaring of a
    companion matrix is not)."""
    m = M.shape[0]
    e0 = jnp.zeros((m,), M.dtype).at[0].set(1)

    def step(carry, _):
        row, vec, P = carry
        return (row @ M, M @ vec, P @ M), (row, vec)

    (_, _, M_L), (K, V) = lax.scan(
        step, (e0, c, jnp.eye(m, dtype=M.dtype)), None, length=L)
    return K, V, M_L


def _powers_host(b, a, L, rem):
    """_powers in float64 on the host, plus M^rem, for concrete
    coefficients: the device then runs no loop at all."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b, a = b / a[0], a / a[0]
    m = b.shape[0] - 1
    M = np.eye(m, k=1)
    M[:, 0] -= a[1:]
    c = b[1:] - a[1:] * b[0]
    K = np.zeros((L, m))
    V = np.zeros((L, m))
    row = np.eye(m)[0]
    vec = c
    for t in range(L):
        K[t], V[t] = row, vec
        row, vec = row @ M, M @ vec
    return (K, V, np.linalg.matrix_power(M, L),
            np.linalg.matrix_power(M, rem))


def _iir_1d(b, a, x, zi, block_len, tables):
    dtype = x.dtype
    M, c, b0 = _state_space(b, a)
    m = M.shape[0]
    n = x.shape[0]
    L = min(block_len, max(n, 1))
    B = -(-n // L)
    pad = B * L - n
    xb = jnp.pad(x, (0, pad)).reshape(B, L)
    rem = n - (B - 1) * L  # real samples in the last block, in [1, L]
    if tables is None:
        K, V, M_L = _powers(M, c, L)
        M_rem = jnp.linalg.matrix_power(M, rem)
    else:
        K, V, M_L, M_rem = (t.astype(dtype) for t in tables)

    # 1) zero-state pass over all blocks at once, as matmuls: the in-block
    # response is the (L, L) lower-triangular Toeplitz matrix of the
    # impulse response h[0] = b0, h[k] = K[k-1] . c, and the block-end
    # state is sum_tau M^(L-1-tau) c x[tau]. The last block holds only
    # `rem` real samples (the rest is padding), so its exact zero-state
    # end state is taken after `rem` samples.
    h = jnp.concatenate([b0[None], K[:L - 1] @ c])
    lag = np.arange(L)[:, None] - np.arange(L)[None, :]
    H = jnp.where(lag >= 0, h[np.maximum(lag, 0)], 0)
    y_zs = xb @ H.T                                       # (B, L)
    d = xb @ V[::-1]                                      # (B, m)
    z_rem_last = xb[-1, :rem] @ V[rem - 1::-1]

    # 2) cross-block affine combine: Z[b+1] = M_L Z[b] + d[b].
    def combine(left, right):
        # Affine map composition right(left(z)); operands carry a leading
        # scan axis inside associative_scan, so batch the matvec explicitly.
        A1, u1 = left
        A2, u2 = right
        return A2 @ A1, (A2 @ u1[..., None])[..., 0] + u2

    A_all = jnp.broadcast_to(M_L, (B, m, m))
    E_A, E_u = lax.associative_scan(combine, (A_all, d))
    # Z_start[b] = effect of blocks 0..b-1 applied to zi.
    zi = jnp.zeros((m,), dtype) if zi is None else jnp.asarray(zi, dtype)
    z_starts_tail = E_u[:-1] + E_A[:-1] @ zi
    z_start = jnp.concatenate([zi[None, :], z_starts_tail], axis=0)  # (B, m)
    # Exact final state: evolve the last block's true start state through its
    # `rem` real samples only (not the zero padding).
    z_final = M_rem @ z_start[-1] + z_rem_last

    # 3) initial-state correction: one matmul.
    y = y_zs + z_start @ K.T
    return y.reshape(-1)[:n], z_final


def iir_block(b, a, x, zi=None, block_len=128, impl="auto"):
    """IIR filter returning (y, final_state) for streaming continuation.

    ``zi`` / the returned state are transposed-DF-II state vectors of length
    coeff_count - 1 (the functional replacement for the reference's ignored
    history pointers, include/gsdr/iir.h:74-75 — here they actually work).
    Supports leading batch axes on ``x``. A planar ComplexArray ``x`` with
    real coefficients (the gsdrIirCC capability — its coefficients are float,
    include/gsdr/iir.h:91-92) filters the two planes independently, which is
    exact by linearity.

    ``impl``: 'auto' / 'xla' — the blocked scan above; no hand-written
    kernel serves the IIR.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"iir_block: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    tables, ok = None, False
    try:
        b_np, a_np = np.asarray(b), np.asarray(a)
    except jax.errors.TracerArrayConversionError:
        pass  # traced coefficients: the tables are built on the device
    else:
        ok = (b_np.ndim == a_np.ndim == 1 and b_np.shape == a_np.shape
              and _MIN_COEFFS <= b_np.shape[0] <= _MAX_COEFFS)
    if ok:
        n = (x.shape if hasattr(x, "shape") else np.shape(x))[-1]
        L = min(block_len, max(n, 1))
        tables = tuple(jnp.asarray(t, jnp.float32) for t in _powers_host(
            b_np, a_np, L, n - (-(-n // L) - 1) * L))
    return _iir_block_xla(b, a, x, zi=zi, block_len=block_len,
                          tables=tables)


@functools.partial(jax.jit, static_argnames=("block_len",))
def _iir_block_xla(b, a, x, zi=None, block_len=128, tables=None):
    """Exact blocked-parallel-scan path (module docstring algorithm)."""
    from gsdr_tpu.carray import ComplexArray, is_planar

    if is_planar(x):
        xs = jnp.stack([x.re, x.im], axis=0)
        zis = None if zi is None else jnp.stack([zi.re, zi.im], axis=0)
        y, zf = _iir_block_xla(b, a, xs, zi=zis, block_len=block_len,
                               tables=tables)
        return ComplexArray(y[0], y[1]), ComplexArray(zf[0], zf[1])

    x = jnp.asarray(x)
    dtype = jnp.promote_types(x.dtype, jnp.asarray(b).dtype)
    dtype = jnp.promote_types(dtype, jnp.float32)
    x = x.astype(dtype)
    b, a = _normalize_coeffs(b, a, dtype)

    batch_shape = x.shape[:-1]
    xb = x.reshape((-1, x.shape[-1]))
    if zi is None:
        zi_b = jnp.zeros((xb.shape[0], b.shape[0] - 1), dtype)
    else:
        zi_b = jnp.asarray(zi, dtype).reshape((-1, b.shape[0] - 1))
    # f32 matmul precision: a GPU matmul may otherwise run in TF32 (~1e-3),
    # which silently breaks the exactness contract of the blocked scan
    with jax.default_matmul_precision("float32"):
        y, zf = jax.vmap(
            lambda xi, zii: _iir_1d(b, a, xi, zii, block_len, tables))(
                xb, zi_b)
    return (
        y.reshape(batch_shape + (x.shape[-1],)),
        zf.reshape(batch_shape + (b.shape[0] - 1,)),
    )


def iir(b, a, x, zi=None, block_len=128, impl="auto"):
    """Exact IIR filter along the last axis (covers gsdrIirFF/CC/Custom).

    ``block_len`` is a performance knob only (the reference's
    samplesPerThread analog); results are exact for any value.
    """
    y, _ = iir_block(b, a, x, zi=zi, block_len=block_len, impl=impl)
    return y


def iir_reference(b, a, x, zi=None):
    """Golden sequential implementation (lax.scan, one sample at a time).

    Bit-for-bit the recurrence the reference documents (src/iir.cu:158-178)
    with correct (never-reset) state; used to validate the blocked scan.
    """
    x = jnp.asarray(x)
    dtype = jnp.promote_types(x.dtype, jnp.asarray(b).dtype)
    dtype = jnp.promote_types(dtype, jnp.float32)
    x = x.astype(dtype)
    b, a = _normalize_coeffs(b, a, dtype)
    M, c, b0 = _state_space(b, a)
    m = M.shape[0]

    def step(z, x_t):
        y_t = b0 * x_t + z[0]
        z = M @ z + c * x_t
        return z, y_t

    def run(x1):
        z = jnp.zeros((m,), dtype) if zi is None else jnp.asarray(zi, dtype)
        _, y = lax.scan(step, z, x1)
        return y

    batch_shape = x.shape[:-1]
    with jax.default_matmul_precision("float32"):
        y = jax.vmap(run)(x.reshape((-1, x.shape[-1])))
    return y.reshape(batch_shape + (x.shape[-1],))


def iir_sos_block(sos, x, zi=None, block_len=128):
    """Cascade of second-order sections returning (y, final_state).

    ``sos`` is (S, 6) scipy-style [b0 b1 b2 a0 a1 a2] rows. ``zi`` / the
    returned state stack per-section transposed-DF-II states along a
    LEADING axis: shape (S,) + batch + (2,) — so long streams keep exact
    continuity section by section (the capability the reference's ignored
    history pointers pretend to offer, include/gsdr/iir.h:74-75).
    """
    sos = jnp.asarray(sos)
    n_sec = sos.shape[0]
    y = x
    zfs = []
    for s in range(n_sec):
        zi_s = None if zi is None else zi[s]
        y, zf = iir_block(sos[s, :3], sos[s, 3:], y, zi=zi_s,
                          block_len=block_len)
        zfs.append(zf)
    from gsdr_tpu.carray import is_planar as _is_planar
    if zfs and _is_planar(zfs[0]):
        from gsdr_tpu.carray import ComplexArray as _CA
        zf_stack = _CA(jnp.stack([z.re for z in zfs], axis=0),
                       jnp.stack([z.im for z in zfs], axis=0))
    else:
        zf_stack = jnp.stack(zfs, axis=0)
    return y, zf_stack


def iir_sos(sos, x, zi=None, block_len=128):
    """Cascade of second-order sections (numerically robust high-order IIR).

    ``sos`` is (S, 6) scipy-style [b0 b1 b2 a0 a1 a2] rows. The reference has
    no cascade API (high-order filters run as one monolithic recurrence);
    this is the conditioning upgrade recommended in SURVEY.md section 7.
    Pass ``zi`` (see iir_sos_block) for streaming continuation.
    """
    y, _ = iir_sos_block(sos, x, zi=zi, block_len=block_len)
    return y
