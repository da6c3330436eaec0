"""The FM channelizer chain as one Pallas kernel, lowered through Triton.

One program covers L = block_m * phases consecutive decimated outputs of
every channel and runs the chain on them without a round trip through
device memory:

1. channel bank: y_c[j] = sum_t x[jD + t] g_c[t], the complex tap bank of
   ops/channelize.py, un-rotated. The program gathers its Toeplitz window
   tiles W[i, t] = x[j_i D + t] straight from the input with
   overlapping-address loads, which L1 serves, and contracts them with
   the taps on the tensor cores.
2. discriminator: gain * angle(y[j] conj(y[j-1]) lo(D)). The rotor of
   output j times the conjugate rotor of output j-1 is the per-channel
   constant lo(D), so no rotor is evaluated (ops/channelize.py,
   fm_discriminate_bank, is the same arithmetic in XLA).
3. de-emphasis, the first-order TDF-II recurrence, exact across programs
   in two passes (the block decomposition of ops/iir.py): each program
   writes its zero-state output and its block-end state; a scan over the
   blocks and one elementwise correction follow in XLA.

Layout inside a program. Output j = j_blk + i * phases + s sits at row i
of phase tile s, and every phase tile is one (block_m, channels)
contraction. The discriminator's previous sample of tile s is tile s-1 at
the same rows, so no value ever moves between rows; tile 0 takes an extra
tile at s = -1, one contraction in phases + 1. The recurrence runs over
the phases elementwise within a row, and the row-start states come from
one (block_m x block_m) lower-triangular matmul of the row-end states.
Programs run in parallel, in any order: nothing is carried between them.

Contraction precision: three TF32 tensor-core passes (TF32x3, about 1e-6
relative). One TF32 pass (about 1e-3) would miss the float32 reference by
far more than the 4.2e-5 the chain is held to. Interpret mode runs on the
CPU, which has no TF32, and contracts in float32 (Precision.HIGHEST).
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.channelize import discriminator_prev, lo_phasor

_BLOCK_M = 64      # rows of every tensor-core tile
_PHASES = 16       # phase tiles per program
_TAP_CHUNK = 64    # taps per gathered window tile
_NUM_WARPS = 4
_SMEM_PER_BLOCK = 232448   # bytes of shared memory one H100 block may use


def _pow2_at_least(n, floor):
    p = floor
    while p < n:
        p *= 2
    return p


def _geometry(num_taps, num_channels):
    """(channels padded, tap chunk, taps padded). Triton tiles are powers
    of two and a dot needs every dimension >= 16."""
    cp = _pow2_at_least(num_channels, 16)
    kc = min(_TAP_CHUNK, _pow2_at_least(num_taps, 16))
    return cp, kc, -(-num_taps // kc) * kc


def _smem_bytes(num_taps, num_channels, stages, block_m=_BLOCK_M):
    """Shared memory Triton asks for: per window tile, (stages - 1) staged
    copies of it and four tap-sized operand buffers, plus one (block_m,
    channels) tile. Exact for every shape measured on an H100."""
    cp, kc, tp = _geometry(num_taps, num_channels)
    chunks = 2 * tp // kc
    return 4 * (chunks * ((stages - 1) * block_m * kc + 4 * kc * cp)
                + block_m * cp)


def _num_stages(num_taps, num_channels, block_m=_BLOCK_M):
    """The most pipeline stages (up to 3) that leave room for two programs
    on one SM; one stage past that. On an H100 (700 W), staging that left
    one program per SM cost up to 1.6x (T=128, C=16: 324.5 against 200.2 us
    per 2^20-sample step) and gained at most 1.2 %."""
    for stages in (3, 2):
        if _smem_bytes(num_taps, num_channels, stages, block_m) \
                <= _SMEM_PER_BLOCK // 2:
            return stages
    return 1


def fm_chain_supported(num_taps, num_channels):
    """True when the kernel runs this chain (any D, any block length): its
    tiles fit in one block's shared memory."""
    return int(num_taps) >= 1 and int(num_channels) >= 1 and _smem_bytes(
        num_taps, num_channels, 1) <= _SMEM_PER_BLOCK


def _tap_matrices(bank, cp, tp):
    """(2C, 2, T) tap bank -> two (2*tp, cp) matrices giving the real and
    imaginary bank outputs; row plane*tp + t multiplies plane(x[jD + t])."""
    k2c, _, t = bank.shape
    c = k2c // 2
    g = jnp.asarray(bank, jnp.float32).reshape(c, 2, 2, t)
    g = jnp.transpose(g, (1, 2, 3, 0))           # (part, plane, t, c)
    g = jnp.pad(g, ((0, 0), (0, 0), (0, tp - t), (0, cp - c)))
    g = g.reshape(2, 2 * tp, cp)
    return g[0], g[1]


def _deemph_consts(b, a):
    b0 = float(b[0]) / float(a[0])
    b1 = float(b[1]) / float(a[0])
    a1 = float(a[1]) / float(a[0])
    return b0, b1 - a1 * b0, -a1                 # b0, TDF-II input gain, pole


def _row_tables(pole, block_m, phases):
    """Lower-triangular row-start matrix pole^(phases*(i-1-k)) for k < i,
    and the block-end weights pole^(phases*(block_m-1-k))."""
    i = np.arange(block_m)[:, None]
    k = np.arange(block_m)[None, :]
    expo = np.where(k < i, phases * (i - 1 - k), 0)
    lmat = np.where(k < i, np.power(float(pole), expo), 0.0)
    rowpow = np.power(float(pole), phases * (block_m - 1 - np.arange(block_m)))
    return lmat.astype(np.float32), rowpow.astype(np.float32)


def _chain_kernel(x_ref, gre_ref, gim_ref, lmat_ref, rowpow_ref, consts_ref,
                  audio_ref, bend_ref, *, stride, x_off, d, tp, kc, cp,
                  block_m, phases, j0, m_pad, gain, b0, cc, pole, precision,
                  barrier):
    blk = pl.program_id(0)
    span = block_m * phases
    rows = jnp.arange(block_m, dtype=jnp.int32)[:, None]
    taps = jnp.arange(kc, dtype=jnp.int32)[None, :]
    cols = jnp.arange(cp, dtype=jnp.int32)[None, :]
    first_row = j0 + blk * span + rows * phases   # output index of phase 0
    # the zero-state output is stored phase-major, (block, phase, channel,
    # row): contiguous along the rows, so the stores coalesce; the XLA
    # epilogue interleaves the phases back into (channel, output)
    out_idx = (blk * phases * cp + cols) * block_m + rows

    def dot(a, b):
        return lax.dot(a, b, precision=precision,
                       preferred_element_type=jnp.float32)

    # tap tiles: loaded once, used by every phase tile
    chunks = [(plane, t0) for plane in range(2) for t0 in range(0, tp, kc)]
    g_tiles = [(gre_ref[r0:r0 + kc, :], gim_ref[r0:r0 + kc, :])
               for r0 in (plane * tp + t0 for plane, t0 in chunks)]

    def bank_tile(j):
        # x is zero-padded so that every window of the grid is in range:
        # no mask, and each row of a window tile is contiguous
        yr = jnp.zeros((block_m, cp), jnp.float32)
        yi = jnp.zeros((block_m, cp), jnp.float32)
        for (plane, t0), (g_re, g_im) in zip(chunks, g_tiles):
            w = x_ref[plane * stride + x_off + t0 + j * d + taps]
            yr = yr + dot(w, g_re)
            yi = yi + dot(w, g_im)
        return yr, yi

    step_re = consts_ref[0, :][None, :]
    step_im = consts_ref[1, :][None, :]
    prev_re0 = consts_ref[2, :][None, :]
    prev_im0 = consts_ref[3, :][None, :]
    zi = consts_ref[4, :][None, :]

    # Pass A, over the phases: bank tile, discriminator and the in-row
    # zero-state recurrence; the discriminator output goes to the audio
    # buffer, and the row-end states stay.
    def pass_a(s, carry):
        pr, pim, z = carry
        j = first_row + s
        yr, yi = bank_tile(j)
        first = j == 0
        pr = jnp.where(first, prev_re0, pr)
        pim = jnp.where(first, prev_im0, pim)
        qr = yr * pr + yi * pim
        qi = yi * pr - yr * pim
        ur = qr * step_re - qi * step_im
        ui = qr * step_im + qi * step_re
        live = (j >= 0) & ((ur != 0) | (ui != 0))   # as fm_discriminate_bank
        dem = jnp.where(live, gain * jnp.arctan2(ui, ur), 0.0)
        zp = z + jnp.where(first, zi, 0.0)   # the carried state enters at j=0
        audio_ref[out_idx + s * (cp * block_m)] = dem
        return yr, yi, pole * zp + cc * dem

    pr, pim = bank_tile(first_row - 1)
    _, _, z_end = lax.fori_loop(
        0, phases, pass_a,
        (pr, pim, jnp.zeros((block_m, cp), jnp.float32)))

    # Row-start states from a zero block start, and the block-end state.
    z_row = dot(lmat_ref[...], z_end)
    bend_ref[blk * cp + jnp.arange(cp, dtype=jnp.int32)] = jnp.sum(
        rowpow_ref[...][:, None] * z_end, axis=0)
    if barrier:   # pass B reads what other threads wrote (the interpreter
        plgpu.debug_barrier()   # runs one thread and has no barrier)

    # Pass B: the exact recurrence again, from the true row-start states.
    def pass_b(s, z):
        j = first_row + s
        at = out_idx + s * (cp * block_m)
        dem = audio_ref[at]
        zp = z + jnp.where(j == 0, zi, 0.0)
        audio_ref[at] = b0 * dem + zp
        return pole * zp + cc * dem

    lax.fori_loop(0, phases, pass_b, z_row)


def fm_chain(buf, bank, lo_table, rot0, decimation, gain, deemph_b,
             deemph_a, carry_f, carry_z, prev=None, block_m=_BLOCK_M,
             phases=_PHASES, interpret=False):
    """Run the fused chain over a tail-prepended planar buffer.

    Args:
      buf: planar (Nb,) RF including the (T-1)-sample history prefix.
      bank: (2C, 2, T) tap bank (make_complex_tap_bank; numpy or traced).
      lo_table: (C, 4) digit-fraction table of the channel shifts.
      rot0: traced int32 — global raw-sample index of window 0, mod Fs.
      decimation, gain, deemph_b, deemph_a: static chain parameters.
      carry_f: planar (C, 1) carried (rotated) discriminator sample.
      carry_z: (C, 1) de-emphasis TDF-II state.
      prev: planar (C, 1) un-rotated sample before output 0, in place of
        the one carry_f gives (ops/channelize.discriminator_prev) — the
        sharded step computes it from its halo.
      block_m / phases: tile rows and phase tiles per program.
      interpret: run in the Pallas interpreter (any backend).

    Returns (audio (C, M), y_last, new_carry_z), M = (Nb - T)//D + 1, with
    y_last the un-rotated last bank output (C, 1): the caller rotates it
    into the carried state (ops/channelize.discriminator_carry), exactly as
    the XLA chain in pipelines/fm_radio.py does, so the two are
    interchangeable mid-stream.
    """
    k2c, _, t = bank.shape
    c = k2c // 2
    d = int(decimation)
    if not fm_chain_supported(t, c):
        raise ValueError(f"fused FM chain: T={t}, C={c} needs more shared "
                         f"memory than the {_SMEM_PER_BLOCK} bytes of a block")
    n_buf = buf.shape[-1]
    m = (n_buf - t) // d + 1
    if m < 1:
        raise ValueError(f"need at least {t} samples, got {n_buf}")
    cp, kc, tp = _geometry(t, c)
    span = block_m * phases
    nblk = -(-m // span)
    m_pad = nblk * span
    pad_front = m_pad - m      # the grid starts early so it ends at M - 1
    # zero padding around each input plane: windows from output
    # -pad_front - 1 to the last tap of output M - 1 stay in range, and a
    # 16-sample multiple keeps the rows of every window tile aligned
    x_off = -(-(pad_front + 1) * d // 16) * 16
    stride = -(-(x_off + n_buf + tp - t) // 16) * 16
    b0, cc, pole = _deemph_consts(deemph_b, deemph_a)
    lmat, rowpow = _row_tables(pole, block_m, phases)

    table = jnp.asarray(lo_table, jnp.float32)
    step = lo_phasor(table, d)
    if prev is None:
        prev = discriminator_prev(carry_f, table, rot0, d)
    consts = jnp.concatenate(
        [step.re, step.im, prev.re, prev.im,
         jnp.asarray(carry_z, jnp.float32)], axis=1).T       # (5, C)
    consts = jnp.pad(consts, ((0, 3), (0, cp - c)))
    gre, gim = _tap_matrices(bank, cp, tp)
    x = jnp.pad(jnp.stack([buf.re, buf.im]).astype(jnp.float32),
                ((0, 0), (x_off, stride - x_off - n_buf))).reshape(-1)

    kernel = _make_kernel(stride=stride, x_off=x_off, d=d, tp=tp, kc=kc, cp=cp,
                          block_m=block_m, phases=phases, j0=-pad_front,
                          m_pad=m_pad, gain=float(gain), b0=b0, cc=cc,
                          pole=pole, interpret=interpret)
    audio_zs, bend = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((m_pad * cp,), jnp.float32),
                   jax.ShapeDtypeStruct((nblk * cp,), jnp.float32)),
        grid=(nblk,),
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_num_stages(t, c, block_m)),
        name="fm_chain",
    )(x, gre, gim, jnp.asarray(lmat), jnp.asarray(rowpow), consts)

    # Cross-block pass: block-start states by a scan over the blocks'
    # affine maps z -> pole^L z + bend, then one elementwise correction
    # (fused with the phase interleave).
    bend = bend.reshape(nblk, cp)[:, :c].T                   # (C, nblk)
    decay = jnp.full(bend.shape, float(pole) ** span, jnp.float32)

    def compose(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    _, ends = lax.associative_scan(compose, (decay, bend), axis=1)
    starts = jnp.concatenate([jnp.zeros((c, 1), jnp.float32), ends[:, :-1]],
                             axis=1)
    ramp = np.power(float(pole), np.arange(span)).astype(np.float32)
    audio = jnp.transpose(audio_zs.reshape(nblk, phases, cp, block_m),
                          (2, 0, 3, 1))[:c]               # output i*phases+s
    audio = audio.reshape(c, nblk, span) + starts[:, :, None] * ramp
    audio = audio.reshape(c, m_pad)[:, pad_front:]

    # the last output again, for the discriminator carry (one window)
    last = buf[..., (m - 1) * d:(m - 1) * d + t]
    y_last = jnp.einsum("opt,pt->o", jnp.asarray(bank, jnp.float32),
                        jnp.stack([last.re, last.im]),
                        precision=lax.Precision.HIGHEST).reshape(c, 2)
    return audio, ComplexArray(y_last[:, :1], y_last[:, 1:]), ends[:, -1:]


def _make_kernel(interpret, **static):
    # the CPU has no TF32: the interpreter contracts in float32
    precision = (lax.Precision.HIGHEST if interpret
                 else lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    return functools.partial(_chain_kernel, precision=precision,
                             barrier=not interpret, **static)

