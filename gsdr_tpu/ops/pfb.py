"""Polyphase filter-bank (PFB) channelizer for uniform channel grids.

The complex-tap-bank channelizer (ops/channelize.py) handles arbitrary
channel frequencies at O(C * T / D) MACs per input sample. When the C = K
channels sit on the uniform grid f_c = c * Fs / K with critical decimation
D = K — the standard wideband-receiver configuration — the classic PFB
factorization does the same job in O(T / K) MACs plus one K-point DFT per
output frame:

    filt[c, j] = sum_t x[jK + t] h[t] e^{-2i pi c (jK + t) / K}
               = DFT_K( u[j, :] )[c],
    u[j, r]    = sum_q x[jK + qK + r] h[qK + r]        (T = Q*K taps)

(the rotor e^{-2i pi c jK / K} = 1 at critical decimation — uniform grids
need no LO at all). The fold u is K parallel stride-1 FIRs of length Q
(grouped conv); the DFT is a dense (K x K) matmul, not jnp.fft. Whether
cuFFT beats the matmul past some K is not measured yet (ROADMAP).

The reference library has no channelizer at all (its dead k_Fm4x kernel,
/root/reference/src/fm.cu:71-179, hand-unrolls 4 channels); this op is a
capability added beyond parity.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from gsdr_tpu.carray import ComplexArray, is_planar


def uniform_grid(shifts_hz, sample_rate, max_k=4096, multiple_of=1):
    """Detect a uniform frequency grid: return (k, bins) with every shift
    f_c = bins[c] * Fs / k for integers bins[c] (mod k) and the smallest
    such k that is a multiple of ``multiple_of`` (callers pass the
    decimation so the PFB front's D | K constraint is met whenever ANY
    valid K exists — e.g. shifts on even bins of an Fs/64 grid give a
    minimal k=32, which D=64 needs lifted to k=64). Returns None when the
    shifts don't sit on such a grid with k <= max_k. Exact rational
    arithmetic — float shifts like Fs/64 are exactly representable, so no
    tolerance games."""
    from fractions import Fraction
    from math import lcm

    fs = Fraction(float(sample_rate))
    if fs == 0:
        return None
    ratios = [Fraction(float(f)) / fs for f in shifts_hz]
    k = lcm(*[r.denominator for r in ratios]) if ratios else 1
    k = lcm(k, max(1, int(multiple_of)))
    if k > int(max_k):
        return None
    bins = [int((r * k) % k) for r in ratios]
    return k, bins


def decimating_grid(shifts_hz, sample_rate, decimation):
    """(k, bins) of the uniform grid with D | k that the PFB front needs,
    or ValueError naming why there is none. uniform_grid(multiple_of=D)
    lifts k to an lcm with D or returns None, so D | k holds whenever a
    grid exists."""
    grid = uniform_grid(shifts_hz, sample_rate, multiple_of=decimation)
    if grid is None:
        raise ValueError(
            "impl='pfb' needs every channel shift on an Fs/K grid with "
            f"D | K (shifts={list(shifts_hz)[:4]}..., Fs={sample_rate}, "
            f"D={decimation})")
    return grid


def pfb_taps_to_polyphase(taps, num_channels):
    """(T,) prototype low-pass -> (K, Q) polyphase matrix, zero-padding T
    up to a multiple of K. Row r holds h[r], h[K+r], h[2K+r], ..."""
    taps = np.asarray(taps, np.float64)
    k = int(num_channels)
    q = -(-len(taps) // k)
    padded = np.zeros(k * q)
    padded[:len(taps)] = taps
    return padded.reshape(q, k).T.astype(np.float32)  # (K, Q)


def _dft_matrices(k):
    """Real/imag parts of the K-point DFT matrix W[c, r] = e^{-2i pi cr/K},
    float64-accurate."""
    c = np.arange(k)[:, None]
    r = np.arange(k)[None, :]
    ang = -2.0 * np.pi * c * r / k
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _dft_bank_matrix(grid_bins, k):
    """Planar (2C, 2K) DFT-bank matrix for the uniform-grid channelizer:
    row pair (2c, 2c+1) evaluates sum_v a[v] * e^{+2i pi g_c v / K} from
    the stacked planar fold A = [a_re; a_im] — the positive sign matches
    make_complex_tap_bank's g_c[t] = h[t] e^{+2i pi f_c t / Fs} with
    f_c = g_c Fs / K (ops/channelize.py:39-66)."""
    c_cnt = len(grid_bins)
    g = np.zeros((2 * c_cnt, 2 * k), np.float64)
    v = np.arange(k)
    for c, gc in enumerate(grid_bins):
        ang = 2.0 * np.pi * ((int(gc) * v) % k) / k
        wr, wi = np.cos(ang), np.sin(ang)
        g[2 * c, :k] = wr
        g[2 * c, k:] = -wi
        g[2 * c + 1, :k] = wi
        g[2 * c + 1, k:] = wr
    return g.astype(np.float32)


def mix_fir_decimate_bank_uniform(x, taps, grid_bins, k_grid, decimation,
                                  dft_bank=None):
    """Uniform-grid drop-in for ops.channelize.mix_fir_decimate_bank:
    planar x (N,) -> planar UNROTATED (C, M), M = (N - T)//D + 1, for
    channel shifts f_c = grid_bins[c] * Fs / k_grid (integer bins).

    filt[c, j] = sum_t x[jD + t] h[t] e^{+2i pi g_c t / K}
               = sum_v e^{+2i pi g_c v / K} a[v, j]            (t = v + Ku)
        a[v, j] = sum_u h[v + Ku] x[jD + v + Ku]               (fold)

    The fold costs T MACs per output FRAME shared by ALL channels (vs the
    dense bank's C*T), and the DFT is one (2C, 2K) matmul — the PFB
    factorization wins by ~T/K = Q on the filter stage. Requires D | K
    (windows then decompose as j = w*(K/D) + p with a per-p lane roll of
    the (N/K, K) sample grid; non-divisor D falls back to the dense bank
    upstream). Same "window starts at j*D" convention as ops/fir.py; the
    caller applies rotate_bank (or rotate_bank_uniform) exactly as for
    the dense bank.

    ``dft_bank``: the (2C, 2K) matrix _dft_bank_matrix(grid_bins, K) builds,
    given as an array instead — the sharded step passes each channel shard
    its rows as a shard_map operand (grid_bins is then unused).

    This is the conclusion of the reference's multi-channel FM intent
    (/root/reference/src/fm.cu:71-179): O(T + C*K) instead of O(C*T) MACs
    per output frame.
    """
    k = int(k_grid)
    d = int(decimation)
    if k % d != 0:
        raise ValueError(f"uniform PFB needs D | K (D={d}, K={k})")
    p_cnt = k // d
    t_len = len(np.asarray(taps))
    hp = jnp.asarray(pfb_taps_to_polyphase(taps, k))  # hp[v, u] = h[v+Ku]
    q = hp.shape[1]

    n = x.shape[-1]
    m = (n - t_len) // d + 1
    if m <= 0:
        raise ValueError(f"need at least {t_len} samples, got {n}")
    nw = -(-m // p_cnt)                          # windows per residue p
    rows = nw + q + 1                            # sample-grid rows needed
    pad = rows * k - n

    def fold(plane):
        xg = jnp.pad(plane, (0, max(0, pad)))[:rows * k].reshape(rows, k)
        outs = []
        for p in range(p_cnt):
            off = p * d
            # xp[w, v] = x[w*K + p*D + v]: lane-roll by p*D with the
            # wrapped lanes taken from the NEXT row
            if off:
                xp = jnp.concatenate(
                    [xg[:-1, off:], xg[1:, :off]], axis=1)
            else:
                xp = xg[:-1, :]
            # a_p[v, w] = sum_u hp[v, u] xp[w + u, v]: depthwise conv
            # along w, one tap row per lane v (feature_group_count = K)
            a = lax.conv_general_dilated(
                xp.T[None], hp[:, None, :],
                window_strides=(1,), padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=k,
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST,
            )[0]                                  # (K, rows - q)
            outs.append(a[:, :nw])
        return jnp.stack(outs, axis=0)            # (P, K, NW)

    a_re = fold(x.re)
    a_im = fold(x.im)
    g = jnp.asarray(_dft_bank_matrix(grid_bins, k) if dft_bank is None
                    else dft_bank)                     # (2C, 2K)
    a_all = jnp.concatenate([a_re, a_im], axis=1)      # (P, 2K, NW)
    f = jnp.einsum("ck,pkw->cpw", g, a_all,
                   precision=jax.lax.Precision.HIGHEST)  # (2C, P, NW)
    # interleave j = w * P + p and trim the ragged tail
    c_cnt = g.shape[0] // 2
    f = jnp.transpose(f.reshape(c_cnt, 2, p_cnt, nw),
                      (0, 1, 3, 2)).reshape(c_cnt, 2, nw * p_cnt)[..., :m]
    return ComplexArray(f[:, 0, :], f[:, 1, :])


def pfb_synthesize(channels, taps, num_channels=None, hop=None):
    """PFB SYNTHESIS bank: planar (..., K, M) channel streams -> planar
    (..., M*hop) wideband stream — the transmit-side inverse of
    pfb_channelize (round 4, beyond reference parity: the reference has
    per-stream modulators but no channel combiner).

    Channel c is placed at +c * Fs / K. Critically sampled (hop = K,
    the default):

        x[jK + r] = sum_q hp[r, q] * v[r, j - q],
        v[r, j]   = sum_c y[c, j] e^{+2i pi c r / K}       (inverse DFT)

    with hp the (K, Q) polyphase split of the interpolation prototype
    ``taps`` (design it like the analysis prototype; gain K is folded in
    so an analysis->synthesis round trip through matched near-perfect-
    reconstruction prototypes approximates identity up to the filters'
    combined response). Streaming: prepend the previous block's last
    (Q-1) v-columns per channel to avoid block-boundary transients
    (callers via stream.py carry (K, Q-1) state); this one-shot form
    zero-primes instead.

    hop = D < K with D | K (round 5): OVERSAMPLED synthesis — each
    channel's frame rate is Fs/D (K/D x oversampled), the dual of the
    analysis side's mix_fir_decimate_bank_uniform(D | K):

        x[n] = D * sum_j h[n - jD] * u_j[n mod K],
        u_j  = IDFT_K( y[:, j] )

    evaluated per output phase d = n mod D (the modulator e^{2i pi c
    n/K} has period K, so u_j at lane n mod K is the full modulated
    sum; the lane window cycles with m mod P, P = K/D). Oversampled
    banks are what make near-perfect-reconstruction duplex chains
    possible — the critical bank's adjacent-channel aliasing is
    structural (dense 256-ary QAM does not survive it) while a 2x bank
    round-trips dense QAM cleanly.
    """
    y = channels if is_planar(channels) else \
        ComplexArray.from_complex(jnp.asarray(channels))
    k = int(num_channels) if num_channels is not None else y.shape[-2]
    if y.shape[-2] != k:
        raise ValueError(f"channels axis {y.shape[-2]} != K={k}")
    if hop is not None and int(hop) != k:
        return _pfb_synthesize_hop(y, taps, k, int(hop))
    poly = jnp.asarray(pfb_taps_to_polyphase(taps, k)) * float(k)  # (K, Q)
    q = poly.shape[1]
    lead = y.shape[:-2]
    m = y.shape[-1]

    # v[r, j] = sum_c y[c, j] W^{+cr}: one (K x K) matmul per plane pair
    yr = y.re.reshape((-1, k, m))
    yi = y.im.reshape((-1, k, m))
    v_re, v_im = _idft_channels(yr, yi, k)

    def interp(v):
        # x-phase r at output frame j: causal per-lane FIR over j
        vpad = jnp.pad(v, ((0, 0), (0, 0), (q - 1, 0)))
        out = lax.conv_general_dilated(
            vpad, poly[:, None, ::-1],      # causal: taps reversed
            window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            feature_group_count=k,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )                                    # (B, K, M)
        return jnp.transpose(out, (0, 2, 1)).reshape(lead + (m * k,))

    return ComplexArray(interp(v_re), interp(v_im))


def _idft_channels(yr, yi, k):
    """u[b, r, m] = sum_c y[b, c, m] e^{+2i pi c r / K}: the synthesis
    banks' channel-axis inverse DFT as two (K x K) HIGHEST-precision
    matmuls per plane (shared by the critical and hop paths)."""
    wr, wi = _dft_matrices(k)     # W[c, r] = e^{-2i pi cr / K}
    hi = "highest"                # e^{+...} = conj: (wr, -wi)
    u_re = jnp.einsum("cr,bcm->brm", jnp.asarray(wr), yr, precision=hi) \
        + jnp.einsum("cr,bcm->brm", jnp.asarray(wi), yi, precision=hi)
    u_im = jnp.einsum("cr,bcm->brm", jnp.asarray(wr), yi, precision=hi) \
        - jnp.einsum("cr,bcm->brm", jnp.asarray(wi), yr, precision=hi)
    return u_re, u_im


def _pfb_synthesize_hop(y, taps, k, d):
    """Oversampled synthesis (hop D < K, D | K): see pfb_synthesize.

    Gain D is folded in (each output sample sums K/D overlapping
    windows; sum_q h[qD + d] ~ 1/D for a unit-DC prototype, so a
    DC channel synthesizes to amplitude ~1, matching the critical
    form's gain-K convention)."""
    if d <= 0 or k % d != 0:
        raise ValueError(f"hop {d} must be a positive divisor of K={k}")
    p_cnt = k // d
    # hd[dph, qq] = h[qq*D + dph] * D  (per-output-phase tap rows)
    hd = jnp.asarray(pfb_taps_to_polyphase(taps, d)) * float(d)  # (D, Qd)
    q_d = hd.shape[1]
    lead = y.shape[:-2]
    m = y.shape[-1]
    # pad the frame count to a P multiple so every output phase carries
    # the same frame count through the strided interleave (causal
    # interpolation: the zero frames only influence outputs at m >= M,
    # which the final slice drops — output-identical)
    m_pad = -(-m // p_cnt) * p_cnt

    pad_cols = [(0, 0)] * (y.re.ndim - 1) + [(0, m_pad - m)]
    ypr = jnp.pad(y.re, pad_cols).reshape((-1, k, m_pad))
    ypi = jnp.pad(y.im, pad_cols).reshape((-1, k, m_pad))

    # u_j[r] = IDFT_K(y[:, j])[r]: the modulator e^{+2i pi c n/K} has
    # period K, so u_j evaluated at lane n mod K IS the full modulated
    # sum — no per-frame phase ramp exists in this direct form (the
    # critical path is the P=1 specialization)
    u_re, u_im = _idft_channels(ypr, ypi, k)

    def interp(u):
        # x[mD + dph] = sum_qq hd[dph, qq] * u[m - qq, (m mod P)*D + dph]
        # per output phase p = m mod P: lanes [pD, (p+1)D) of u, a causal
        # per-lane FIR over m evaluated at m = wP + p (stride-P conv on a
        # p-shifted input)
        upad = jnp.pad(u, ((0, 0), (0, 0), (q_d - 1, 0)))
        outs = []
        w_cnt = m_pad // p_cnt
        for p in range(p_cnt):
            up = upad[:, p * d:(p + 1) * d, p:]            # (B, D, ...)
            xp = lax.conv_general_dilated(
                up, hd[:, None, ::-1],                     # causal
                window_strides=(p_cnt,), padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=d,
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST,
            )                                              # (B, D, W_p)
            outs.append(xp[..., :w_cnt])
        stack = jnp.stack(outs, axis=2)                    # (B, D, P, W)
        x = jnp.transpose(stack, (0, 3, 2, 1))             # (B, W, P, D)
        x = x.reshape((x.shape[0], w_cnt * p_cnt * d))[..., :m * d]
        return x.reshape(lead + (m * d,))

    return ComplexArray(interp(u_re), interp(u_im))


def pfb_synthesize_block(channels, taps, num_channels=None, tail=None,
                         hop=None):
    """Streaming pfb_synthesize: (out (..., M*hop), new_tail). ``tail``
    is the previous block's last (K, Qh-1) channel columns, Qh =
    ceil(T/hop) (planar; zeros at stream start) — block-split output is
    exactly the single-shot output (tested), following the repo's
    (state, block) convention. ``hop`` as in pfb_synthesize (default K,
    critical).

    Frame-phase note for hop < K: the modulator rides on n mod K of the
    local (tail + block) stream, so block boundaries must sit at global
    frame offsets that are multiples of P = K/hop for the lane pattern
    to match the one-shot stream. Two conditions guarantee it: block
    frame counts are P multiples (validated), and the carried tail is
    rounded UP to a P multiple of frames (extra history frames only add
    windows whose outputs fall in the discarded warm-up span —
    output-identical; at hop=K, P=1 and this reduces exactly to the
    round-4 critical behavior)."""
    y = channels if is_planar(channels) else \
        ComplexArray.from_complex(jnp.asarray(channels))
    k = int(num_channels) if num_channels is not None else y.shape[-2]
    d = int(hop) if hop is not None else k
    if d <= 0 or k % d != 0:
        raise ValueError(f"hop {d} must be a positive divisor of K={k}")
    p_cnt = k // d
    if d != k and y.shape[-1] % p_cnt != 0:
        # a non-P-multiple block would shift every later block's output
        # phase pattern relative to the one-shot stream
        raise ValueError(
            f"block frame count {y.shape[-1]} must be a multiple of "
            f"P = K/hop = {p_cnt} (output-phase alignment across "
            "blocks)")
    q = -(-len(np.asarray(taps)) // d)
    t_len = -(-(q - 1) // p_cnt) * p_cnt   # P-aligned carried history
    if tail is None:
        tail = ComplexArray.zeros(y.shape[:-1] + (t_len,))
    buf = ComplexArray(
        jnp.concatenate([tail.re, y.re], axis=-1),
        jnp.concatenate([tail.im, y.im], axis=-1))
    out = pfb_synthesize(buf, taps, k, hop=d)
    # tail from the CONCATENATED stream: a block shorter than the tail
    # must keep part of the previous tail (code-review round 4)
    new_tail = buf[..., buf.shape[-1] - t_len:]
    return out[..., t_len * d:], new_tail


def pfb_channelize_block(x, taps, num_channels, tail=None):
    """Streaming pfb_channelize: (filt (..., K, N//K), new_tail). ``tail``
    is the previous block's last (Q-1)*K raw samples (planar; zeros at
    stream start); N must divide by K. Block-split == single-shot
    (tested)."""
    k = int(num_channels)
    xp = x if is_planar(x) else ComplexArray.from_complex(jnp.asarray(x))
    if xp.shape[-1] % k != 0:
        # A non-K-multiple block would silently restart frames at a non-K
        # offset for every subsequent block (the carried tail is always a
        # K-multiple) — wrong output with no error (advisor, round 4).
        raise ValueError(
            f"block length {xp.shape[-1]} must be a multiple of "
            f"num_channels={k} (frame alignment across blocks)")
    q = -(-len(np.asarray(taps)) // k)
    hist = (q - 1) * k
    if tail is None:
        tail = ComplexArray.zeros(xp.shape[:-1] + (hist,))
    buf = ComplexArray(
        jnp.concatenate([tail.re, xp.re], axis=-1),
        jnp.concatenate([tail.im, xp.im], axis=-1))
    out = pfb_channelize(buf, taps, k)
    # tail from the CONCATENATED stream: a block shorter than (Q-1)*K
    # samples must keep part of the previous tail (code-review round 4)
    new_tail = buf[..., buf.shape[-1] - hist:]
    return out, new_tail


def pfb_channelize(x, taps, num_channels, impl="xla"):
    """Critically-sampled PFB: planar (..., N) -> planar (..., K, N//K - Q + 1).

    Channel c carries the band centered at c * Fs / K (c wraps: channels
    above K/2 are negative frequencies), filtered by the prototype
    ``taps`` and decimated by K. Matches
    channelize(x, taps, shifts=[-c*Fs/K ...], decimation=K) output windows
    aligned at j*K (same "window starts at j*D" convention as ops/fir.py).

    impl: 'xla' / 'auto' — fold conv + DFT matmul (above); no
    hand-written kernel serves the PFB.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"pfb_channelize: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    k = int(num_channels)
    if not is_planar(x):
        x = ComplexArray.from_complex(jnp.asarray(x))
    poly = jnp.asarray(pfb_taps_to_polyphase(taps, k))  # (K, Q)
    q = poly.shape[1]
    n = x.shape[-1]
    m = n // k - q + 1  # output frames
    if m <= 0:
        raise ValueError(f"need at least {k * q} samples, got {n}")
    lead = x.shape[:-1]

    def fold(plane):
        # (..., N) -> phases (B*K batch of length n//k) -> grouped conv
        ph = plane[..., :(n // k) * k].reshape((-1, n // k, k))
        ph = jnp.transpose(ph, (0, 2, 1))           # (B, K, n//k)
        out = lax.conv_general_dilated(
            ph, poly[:, None, :],                   # (K out, 1 in, Q)
            window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            feature_group_count=k,
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )                                           # (B, K, m)
        return out

    u_re = fold(x.re)   # (B, K, m): u[j, r] per batch, r in channel dim
    u_im = fold(x.im)

    wr, wi = _dft_matrices(k)
    wrj, wij = jnp.asarray(wr), jnp.asarray(wi)
    # filt[c, j] = sum_r W[c, r] * u[j, r]; complex W x complex u.
    hi = "highest"  # DFT matmul must not silently drop to TF32
    f_re = jnp.einsum("cr,brm->bcm", wrj, u_re, precision=hi) \
        - jnp.einsum("cr,brm->bcm", wij, u_im, precision=hi)
    f_im = jnp.einsum("cr,brm->bcm", wij, u_re, precision=hi) \
        + jnp.einsum("cr,brm->bcm", wrj, u_im, precision=hi)
    out_shape = lead + (k, m)
    return ComplexArray(f_re.reshape(out_shape), f_im.reshape(out_shape))
