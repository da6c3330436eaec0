"""256-ary QPSK (QPSK256) modulation / demodulation.

Capability parity with /root/reference/src/qpsk256.cu (API include/gsdr/
qpsk256.h:125-230). Two constellation geometries, reproduced exactly:

* rectangular (src/qpsk256.cu:29-38): 16x16 grid indexed i*16+q with
  I = (i-7.5)/7.5*A, Q = (q-7.5)/7.5*A;
* circular (src/qpsk256.cu:41-71): concentric rings of {1,8,16,24,32,40,48,
  56} points at radii {0,.3,.6,.85,1.1,1.35,1.6,1.85}*A, ring p angle
  2*pi*p/points + 0.5*ring_index, plus 31 remainder points at radius 0.95*A
  and angle 2*pi*index/256.

The reference requires a device-side init kernel + cudaMemcpyToSymbol into
__constant__ memory before use (src/qpsk256.cu:262-295); here a
constellation is just an array you pass in — build once with
qpsk256_constellation().

Demodulation replaces the reference's per-sample O(256) nearest-neighbor
loop (src/qpsk256.cu:172-192) with one matmul: argmin_i |x - C_i|^2 =
argmin_i (|C_i|^2 - 2 Re(x conj(C_i))), computed for all samples against all
256 points as an (N, 2) x (2, 256) dot. Ties break to the lowest symbol
index, like the reference's strict < comparison.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gsdr_tpu.carray import ComplexArray, is_planar

RECTANGULAR = 0
CIRCULAR = 1


def qpsk256_constellation(constellation_type=RECTANGULAR, amplitude=1.0,
                          planar=False):
    """Build the 256-point table, indexed by symbol value.

    Returns complex64 by default, or a planar ComplexArray with
    ``planar=True``. Built host-side in numpy — the functional replacement
    for the reference's init-kernel + __constant__-memory upload dance
    (src/qpsk256.cu:262-295).
    """
    a = float(amplitude)
    pts = np.zeros(256, dtype=np.complex64)
    if constellation_type == RECTANGULAR:
        i = np.arange(16)
        ii, qq = np.meshgrid(i, i, indexing="ij")
        vals = ((ii - 7.5) / 7.5 * a + 1j * (qq - 7.5) / 7.5 * a)
        pts[:] = vals.reshape(-1).astype(np.complex64)
    elif constellation_type == CIRCULAR:
        points_per_circle = [1, 8, 16, 24, 32, 40, 48, 56]
        radii = [0.0, 0.3, 0.6, 0.85, 1.1, 1.35, 1.6, 1.85]
        idx = 0
        for circle, (points, radius) in enumerate(zip(points_per_circle, radii)):
            points = min(points, 256 - idx)
            r = radius * a
            for p in range(points):
                if idx >= 256:
                    break
                # np.float32 arithmetic mirrors the reference's device floats.
                ang = 2.0 * np.pi * p / points + circle * 0.5
                pts[idx] = np.complex64(r * np.cos(ang) + 1j * r * np.sin(ang))
                idx += 1
        while idx < 256:
            ang = 2.0 * np.pi * idx / 256.0
            r = 0.95 * a
            pts[idx] = np.complex64(r * np.cos(ang) + 1j * r * np.sin(ang))
            idx += 1
    else:
        raise ValueError(f"unknown constellation type {constellation_type}")
    # numpy on purpose (project convention for host-side constant tables):
    # a numpy table stays concrete under an active jit trace.
    if planar:
        return ComplexArray(
            pts.real.copy().astype(np.float32),
            pts.imag.copy().astype(np.float32),
        )
    return pts


def _check_table(constellation):
    shape = (constellation.shape if is_planar(constellation)
             else jnp.asarray(constellation).shape)
    if shape != (256,):
        raise ValueError(
            f"constellation must have exactly 256 points, got shape {shape} "
            "(build one with qpsk256_constellation)")


def qpsk256_modulate(symbols, constellation):
    """Symbol byte values (..., N) -> samples via table lookup.

    Parity with gsdrQpsk256Modulate (src/qpsk256.cu:74-101); the 4x variant
    is a leading batch axis. Representation follows ``constellation``:
    complex64 table -> complex64 samples, planar table -> ComplexArray.
    """
    _check_table(constellation)
    symbols = jnp.asarray(symbols).astype(jnp.int32)
    if is_planar(constellation):
        return ComplexArray(constellation.re[symbols], constellation.im[symbols])
    return jnp.asarray(constellation)[symbols]


def qpsk256_modulate_rect(symbols, amplitude=1.0):
    """Arithmetic modulation for the RECTANGULAR constellation.

    index i*16+q maps to I=(i-7.5)/7.5*A, Q=(q-7.5)/7.5*A
    (src/qpsk256.cu:29-38), so the table gather becomes two integer ops
    and a multiply-add per symbol.
    Bit-identical to qpsk256_modulate with the rectangular table."""
    s = jnp.asarray(symbols).astype(jnp.int32)
    scale = float(amplitude) / 7.5
    i = jnp.right_shift(s, 4).astype(jnp.float32)
    q = jnp.bitwise_and(s, 15).astype(jnp.float32)
    return ComplexArray((i - 7.5) * scale, (q - 7.5) * scale)


_CIRC_POINTS = (1, 8, 16, 24, 32, 40, 48, 56)
_CIRC_RADII = (0.0, 0.3, 0.6, 0.85, 1.1, 1.35, 1.6, 1.85)
_CIRC_STARTS = (0, 1, 9, 25, 49, 81, 121, 169)  # cumulative; remainder at 225
_TWO_PI = 6.283185307179586


def qpsk256_modulate_circular(symbols, amplitude=1.0):
    """Arithmetic modulation for the CIRCULAR constellation (round 3).

    Reconstructs the ring geometry (src/qpsk256.cu:41-71) per symbol:
    ring k = searchsorted(starts, s) via 8 compares, angle
    2*pi*(s-start_k)/points_k + 0.5*k (remainder: 2*pi*s/256 at r=0.95A),
    then one f32 sin/cos pair — a few dozen elementwise ops instead of a
    table gather. Values agree
    with the float64-built table to f32 sin/cos accuracy (~1e-7 rel,
    five orders below the ~0.1A inter-point spacing), so decisions
    through any of the demodulators are unaffected; use
    qpsk256_modulate with the table when bit-identity to the reference
    table matters more than speed."""
    a = float(amplitude)
    s = jnp.asarray(symbols).astype(jnp.int32)
    ring = jnp.zeros(s.shape, jnp.int32)
    for t in list(_CIRC_STARTS[1:]) + [225]:
        ring = ring + (s >= t).astype(jnp.int32)  # 0..8 (8 = remainder)

    def sel(table, default):
        out = jnp.full(s.shape, float(default), jnp.float32)
        for k in range(7, -1, -1):
            out = jnp.where(ring == k, float(table[k]), out)
        return out

    radius = sel([r * a for r in _CIRC_RADII], 0.95 * a)
    start = sel(_CIRC_STARTS, 0.0)
    invp = sel([1.0 / p for p in _CIRC_POINTS], 1.0 / 256.0)
    offs = jnp.where(ring == 8, 0.0, 0.5 * ring.astype(jnp.float32))
    ang = _TWO_PI * (s.astype(jnp.float32) - start) * invp + offs
    return ComplexArray(radius * jnp.cos(ang), radius * jnp.sin(ang))


def qpsk256_demodulate_circular(x, amplitude=1.0, out_dtype=jnp.uint8):
    """Ring-decomposed nearest-neighbor demod for CIRCULAR (round 3).

    Within a full ring the nearest point is the nearest angle, so the
    256-point exhaustive search reduces to 11 candidates: the origin
    point (ring 0), the angularly-nearest point of each full ring 1..7
    (angular error < pi/8, so cos(eps) evaluates exactly enough as a
    2-term polynomial), and for the 31-point remainder ARC (symbols
    225..255 span only ~0.73 turn of the 0.95A ring) the nearest in-arc
    point plus the two constant arc endpoints. ~20x less arithmetic than
    the exhaustive score matrix; decisions agree with qpsk256_demodulate
    everywhere except exact Voronoi-boundary ties (measure zero — the
    two scores round differently; both candidates are nearest). Verified
    against the exhaustive demod in tests/test_qpsk256.py."""
    a = float(amplitude)
    xp = x if is_planar(x) else ComplexArray.from_complex(jnp.asarray(x))
    re, im = xp.re, xp.im
    rho2 = re * re + im * im
    theta = jnp.arctan2(im, re)  # [-pi, pi]

    # ring 0: the origin point, symbol 0
    best_d = rho2
    best_i = jnp.zeros(re.shape, jnp.int32)

    for k in range(1, 8):
        pts = _CIRC_POINTS[k]
        r = _CIRC_RADII[k] * a
        u = (theta - 0.5 * k) * (pts / _TWO_PI)
        p = jnp.round(u)
        eps = (u - p) * (_TWO_PI / pts)  # |eps| <= pi/pts <= pi/8
        # cos(eps) to < 3e-8 abs at |eps| <= pi/8 (alternating series)
        cos_eps = 1.0 + eps * eps * (-0.5 + eps * eps * (1.0 / 24.0))
        d = rho2 + r * r - 2.0 * r * jnp.sqrt(rho2) * cos_eps
        idx = _CIRC_STARTS[k] + jnp.mod(p.astype(jnp.int32), pts)
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, idx, best_i)

    # remainder arc: 31 points at r=0.95A, angles 2*pi*s/256, s in 225..255
    r = 0.95 * a
    th = jnp.where(theta < 0, theta + _TWO_PI, theta)  # [0, 2*pi)
    c = jnp.round(th * (256.0 / _TWO_PI))
    in_arc = (c >= 225) & (c <= 255)
    eps = th - c * (_TWO_PI / 256.0)  # |eps| <= pi/256 when in arc
    cos_eps = 1.0 + eps * eps * (-0.5 + eps * eps * (1.0 / 24.0))
    d = jnp.where(in_arc,
                  rho2 + r * r - 2.0 * r * jnp.sqrt(rho2) * cos_eps,
                  jnp.inf)
    better = d < best_d
    best_d = jnp.where(better, d, best_d)
    best_i = jnp.where(better, c.astype(jnp.int32), best_i)
    for end in (225, 255):  # arc endpoints as constant points
        ang = _TWO_PI * end / 256.0
        d = rho2 + r * r - 2.0 * (re * (r * np.cos(ang))
                                  + im * (r * np.sin(ang)))
        better = d < best_d
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, jnp.int32(end), best_i)
    return best_i.astype(out_dtype)


def qpsk256_demodulate_rect(x, amplitude=1.0, out_dtype=jnp.uint8):
    """Exact nearest-neighbor demod for the RECTANGULAR constellation.

    The 16x16 grid's Voronoi cells are axis-aligned squares, so nearest
    neighbor is independent per-axis quantization: idx = clip(round(
    v/A*7.5 + 7.5), 0, 15), symbol = i*16 + q (src/qpsk256.cu:29-38
    indexing). O(1) per sample — vs the O(256) exhaustive search — and
    bit-identical to it away from exact cell boundaries (on a boundary the
    exhaustive search's strict < tie-break may pick the other neighbor;
    both are nearest)."""
    xp = x if is_planar(x) else ComplexArray.from_complex(jnp.asarray(x))
    scale = 7.5 / float(amplitude)

    def quant(v):
        return jnp.clip(jnp.round(v * scale + 7.5), 0, 15).astype(jnp.int32)

    sym = quant(xp.re) * 16 + quant(xp.im)
    return sym.astype(out_dtype)


def qpsk256_demodulate(x, constellation, out_dtype=jnp.uint8, impl="auto"):
    """Complex samples (..., N) -> nearest-constellation symbol values.

    Replaces the reference's exhaustive per-sample loop
    (src/qpsk256.cu:154-195) with nearest-neighbor over the full table as
    one matmul + argmin. impl: 'auto' / 'xla' (no kernel serves it). For
    the rectangular geometry prefer qpsk256_demodulate_rect (exact, O(1)
    per sample).
    """
    _check_table(constellation)
    if impl not in ("auto", "xla"):
        raise ValueError(f"qpsk256_demodulate: unknown impl {impl!r} "
                         "(expected 'auto' or 'xla')")
    xp = x if is_planar(x) else ComplexArray.from_complex(jnp.asarray(x))
    cp = constellation if is_planar(constellation) else \
        ComplexArray.from_complex(jnp.asarray(constellation))
    shape = xp.shape
    xf = jnp.stack([xp.re.reshape(-1), xp.im.reshape(-1)], axis=-1)  # (N, 2)
    ct = jnp.stack([cp.re, cp.im], axis=0)  # (2, 256)
    cross = jnp.dot(xf, ct, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)  # (N, 256)
    score = jnp.sum(ct * ct, axis=0)[None, :] - 2.0 * cross  # |C|^2 - 2 x.C
    best = jnp.argmin(score, axis=-1).astype(out_dtype)
    return best.reshape(shape)
