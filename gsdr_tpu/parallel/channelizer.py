"""Sharded pipeline steps: FIR and the AM/FM channelizers over a mesh.

Builds shard_map'd versions of the gsdr_tpu.pipelines step functions over a
(channel, time) mesh (gsdr_tpu.parallel.mesh):

  * channels shard with zero communication — each chip holds the rows of the
    complex-tap-bank conv kernel (gsdr_tpu.ops.channelize) for its channels
    (the reference's Nx multi-stream families, embarrassingly parallel);
  * the time axis shards the raw RF stream with one (T-1+D)-sample
    left-halo ppermute: T-1 samples for the channelizer windows and D more
    so that every shard computes its left neighbour's last filtered sample
    itself, the FM discriminator's +1-sample contract (the reference's
    warp shuffle, /root/reference/src/fm.cu:58-64) with no second exchange;
    one all-gather of the de-emphasis states and a psum-masked broadcast
    of the stream tail complete the carried state;
  * oscillator phase is communication-free: every device mints its exact
    LO phases from global sample indices (gsdr_tpu.utils.phase).

Streaming state lives replicated over 'time' (the RF tail is channel-
agnostic) with per-channel state sharded over 'channel', so a sharded step
composes exactly like the single-chip step: same state pytree, same
semantics, N/decimation outputs per N-sample block.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.channelize import (
    discriminator_carry,
    discriminator_prev,
    fm_discriminate_bank,
    mix_fir_decimate_bank,
)
from gsdr_tpu.ops.fir import fir
from gsdr_tpu.ops.iir import iir_block
from gsdr_tpu.ops.pfb import _dft_bank_matrix, mix_fir_decimate_bank_uniform
from gsdr_tpu.ops.quad_demod import quad_am_demod
from gsdr_tpu.parallel.halo import left_halo, last_shard_tail


def _shmap(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


def sharded_fir(x, taps, mesh, decimation=1, tail=None):
    """FIR + decimation with x (C, N) sharded over ('channel', 'time').

    Streaming convention: output j uses the input window *ending* at j*D
    (history prepended), so each shard needs a (T-1)-sample left halo; shard
    0 uses ``tail`` (the carried stream history, (C, T-1)) or zeros. Returns
    (C, N/D) with the same sharding as x.
    """
    taps = jnp.asarray(taps, jnp.float32)
    nt = int(taps.shape[0])
    t_shards = mesh.shape["time"]
    if x.shape[-1] % (t_shards * decimation) != 0:
        raise ValueError("N must divide by time_shards * decimation")
    if tail is None:
        tail = ComplexArray.zeros(x.shape[:-1] + (nt - 1,)) \
            if isinstance(x, ComplexArray) else \
            jnp.zeros(x.shape[:-1] + (nt - 1,), jnp.float32)

    def body(x_l, tail_l):
        buf = left_halo(x_l, "time", nt - 1, fill=tail_l)
        return fir(buf, taps, decimation)

    return _shmap(
        body, mesh,
        in_specs=(P("channel", "time"), P("channel", None)),
        out_specs=P("channel", "time"),
    )(x, tail)


def _front(model, mesh):
    """(bank operand, its PartitionSpec, fn(buf, bank_l) -> un-rotated
    (C_l, M) bank output) for the model's channelizer front. The dense
    front shards the (2C, 2, T) tap bank by channel; impl='pfb' shards the
    (2C, 2K) DFT bank of the uniform grid the same way."""
    c_shards = mesh.shape["channel"]
    if model.num_channels % c_shards != 0:
        raise ValueError(
            f"{model.num_channels} channels do not split over "
            f"{c_shards} channel shards")
    dec = model.decimation
    if model.impl == "pfb":
        k_grid, bins = model._pfb_grid()
        taps = model.low_pass_taps

        def apply(buf, bank_l):
            return mix_fir_decimate_bank_uniform(buf, taps, None, k_grid, dec,
                                                 dft_bank=bank_l)

        return _dft_bank_matrix(bins, k_grid), P("channel", None), apply

    def apply(buf, bank_l):
        return mix_fir_decimate_bank(buf, bank_l, dec)

    return model._tap_bank(), P("channel", None, None), apply


def make_sharded_fm_step(model, mesh):
    """shard_map'd FmChannelizer.step over a ('channel', 'time') mesh.

    Returns the jitted ``step(state, rf_planar)`` with the same
    signature/state pytree as the single-device model.step. rf is a planar (N,) block sharded over
    'time'; audio comes back (C, N/D) sharded over ('channel', 'time').

    Dispatch follows the model (gsdr_tpu.backend.use_kernel): the fused
    kernel runs on every shard's halo'd local block where model.step would
    run it, the XLA chain (dense or impl='pfb' front) elsewhere. Per shard:

      * a (T-1+D)-sample left-halo ppermute: T-1 for the filter windows
        plus D so each shard computes the PREVIOUS shard's last filtered
        sample locally — one extra window instead of a second exchange;
      * the chain runs with zero de-emphasis state, and the cross-shard
        IIR recurrence is restored EXACTLY by linearity (the first-order
        case of parallel/iir.py): one all_gather of the (C_l, 1)
        zero-state final states, then audio += z_start * a^j.

    Communication per step: one (T-1+D)-sample ppermute, one (C_l,)
    all_gather and two psums of (C_l,) values — O(halo), independent of N.
    """
    t_shards = mesh.shape["time"]
    nt = model.num_taps
    dec = model.decimation
    gain = model.gain
    fs = int(round(model.sample_rate))
    b, a = model._deemph()
    pole = -float(a[1]) / float(a[0])
    bank_host, bank_spec, front = _front(model, mesh)
    table_host = jnp.asarray(model._lo_table())       # (C, 4)
    halo = nt - 1 + dec
    kernel = model.uses_kernel()
    if kernel:
        from gsdr_tpu.kernels.fm_chain_triton import fm_chain

    def body(n0, tail_re, tail_im, car_re, car_im, zi, bank, table,
             rf_re, rf_im):
        s = lax.axis_index("time")
        n_l = rf_re.shape[-1]
        m_l = n_l // dec
        rf_l = ComplexArray(rf_re, rf_im)
        zpad = jnp.zeros((dec,), jnp.float32)
        fill = ComplexArray(jnp.concatenate([zpad, tail_re], -1),
                            jnp.concatenate([zpad, tail_im], -1))
        ext = left_halo(rf_l, "time", halo, fill=fill)   # (T-1+D+n_l,)
        buf = ext[..., dec:]                             # (T-1+n_l,)

        # window 0 of this shard starts at global index
        # n0 - (T-1) + s*n_l; the discriminator's previous sample is the
        # left neighbour's last output (one window of the halo), or for
        # shard 0 the carried state
        rot0 = (n0 + (s * jnp.int32(n_l % fs)) % fs
                + jnp.int32((fs - (nt - 1) % fs) % fs)) % fs
        carry = ComplexArray(car_re, car_im)
        y_prev = front(ext[..., :nt], bank)              # (C_l, 1)
        first = discriminator_prev(carry, table, rot0, dec)
        prev = ComplexArray(jnp.where(s == 0, first.re, y_prev.re),
                            jnp.where(s == 0, first.im, y_prev.im))

        zeros_z = jnp.zeros_like(zi)
        if kernel:
            audio0, y_last, zcar = fm_chain(
                buf, bank, table, rot0, dec, gain, b, a, carry, zeros_z,
                prev=prev, interpret=model.interpret)
        else:
            y = front(buf, bank)
            demod = fm_discriminate_bank(y, prev, table, dec, gain)
            y_last = y[..., m_l - 1:]
            audio0, zcar = iir_block(
                np.asarray(b, np.float32), np.asarray(a, np.float32),
                demod, zi=zeros_z, block_len=256)

        # exact cross-shard de-emphasis restore (linearity; float64 host
        # powers — pole^m_l underflows to 0 for long shards, which is the
        # right limit: the pole's memory died out)
        pow_l = np.power(pole, m_l * np.arange(t_shards + 1, dtype=np.float64))
        pow_l = pow_l.astype(np.float32)
        ajs = np.power(pole, np.arange(m_l, dtype=np.float64))
        d_all = lax.all_gather(zcar, "time")             # (t_sh, C_l, 1)
        powj = jnp.asarray(pow_l)
        z_start = powj[s] * zi
        for k in range(t_shards):
            zk = jnp.where(k < s, powj[jnp.clip(s - 1 - k, 0, t_shards)], 0.0)
            z_start = z_start + zk * d_all[k]
        audio = audio0 + z_start * jnp.asarray(ajs, jnp.float32)[None, :]
        zf = float(pow_l[t_shards]) * zi
        for k in range(t_shards):
            zf = zf + float(pow_l[t_shards - 1 - k]) * d_all[k]

        last = jnp.where(s == t_shards - 1, 1.0, 0.0)
        y_end = ComplexArray(lax.psum(last * y_last.re, "time"),
                             lax.psum(last * y_last.im, "time"))
        n0_new = (n0 + jnp.int32((n_l * t_shards) % fs)) % fs
        rot0_next = (n0_new + jnp.int32((fs - (nt - 1) % fs) % fs)) % fs
        new_carry = discriminator_carry(y_end, table, rot0_next, dec)
        new_tail = last_shard_tail(rf_l, "time", nt - 1)
        return (n0_new, new_tail.re, new_tail.im, new_carry.re,
                new_carry.im, zf, audio)

    rep = P()  # replicated
    chan = P("channel", None)
    mapped = _shmap(
        body, mesh,
        in_specs=(rep, rep, rep, chan, chan, chan, bank_spec, chan,
                  P("time"), P("time")),
        out_specs=(rep, rep, rep, chan, chan, chan, P("channel", "time")),
    )

    def step(state, rf):
        n0, tail, carry, zi = state
        if rf.shape[-1] % (t_shards * dec) != 0:
            raise ValueError("N must divide by time_shards * decimation")
        (n0n, tre, tim, cre, cim, zin, audio) = mapped(
            n0, tail.re, tail.im, carry.re, carry.im, zi,
            bank_host, table_host, rf.re, rf.im,
        )
        return (n0n, ComplexArray(tre, tim), ComplexArray(cre, cim), zin), audio

    return jax.jit(step)


def make_sharded_am_step(model, mesh):
    """shard_map'd AmReceiver.step over a ('channel', 'time') mesh.

    The AM chain is memoryless past the filter window (src/am.cu:21-50)
    and the envelope cancels the LO rotor, so each shard runs the bank
    (dense, or impl='pfb') on its halo'd block: one ppermute, no gathers."""
    t_shards = mesh.shape["time"]
    nt = model.num_taps
    dec = model.decimation
    fs = int(round(model.sample_rate))
    bank_host, bank_spec, front = _front(model, mesh)

    def body(n0, tail_re, tail_im, bank, rf_re, rf_im):
        rf_l = ComplexArray(rf_re, rf_im)
        buf = left_halo(rf_l, "time", nt - 1,
                        fill=ComplexArray(tail_re, tail_im))
        audio = quad_am_demod(front(buf, bank))
        new_tail = last_shard_tail(rf_l, "time", nt - 1)
        n_total = rf_re.shape[-1] * t_shards
        n0_new = (n0 + jnp.int32(n_total % fs)) % fs
        return n0_new, new_tail.re, new_tail.im, audio

    rep = P()
    mapped = _shmap(
        body, mesh,
        in_specs=(rep, rep, rep, bank_spec, P("time"), P("time")),
        out_specs=(rep, rep, rep, P("channel", "time")),
    )

    def step(state, rf):
        n0, tail = state
        if rf.shape[-1] % (t_shards * dec) != 0:
            raise ValueError("N must divide by time_shards * decimation")
        n0n, tre, tim, audio = mapped(n0, tail.re, tail.im, bank_host,
                                      rf.re, rf.im)
        return (n0n, ComplexArray(tre, tim)), audio

    return jax.jit(step)
