"""Distributed layer on an 8-virtual-device CPU mesh.

Correctness bar: a sharded step must produce the SAME outputs and carried
state as the single-chip step — halo exchange, cross-shard IIR state
propagation, and global-index phase must all compose exactly (within f32
reassociation tolerance). This is the coverage the single-GPU reference
never had (SURVEY.md section 4: "Distributed/multi-node testing: none").
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

from gsdr_tpu import fir, iir
from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.parallel import (
    left_halo,
    make_mesh,
    make_sharded_am_step,
    make_sharded_fm_step,
    right_halo,
    sharded_fir,
    sharded_iir,
)
from gsdr_tpu.pipelines import AmReceiver, FmChannelizer

RNG = np.random.default_rng(7)


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _planar(shape):
    z = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
    return ComplexArray.from_complex(z.astype(np.complex64))


def _fm_rf(freqs_hz, n, fs=1_000_000.0):
    """Real FM carriers for discriminator comparisons: white noise puts
    samples on the atan2 +-pi branch cut where two correct atan2
    implementations legitimately differ by 2*pi."""
    t = np.arange(n) / fs
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs_hz):
        msg = np.sin(2 * np.pi * 800.0 * (k + 1) * t)
        sig += (0.9 / max(len(freqs_hz), 1)) * np.exp(
            1j * (2 * np.pi * f * t + 0.4 * msg))
    return ComplexArray.from_complex(sig.astype(np.complex64))


class TestHalo:
    def _run(self, fn, x, spec_in, spec_out, mesh):
        return shard_map_fn(fn, mesh=mesh, in_specs=spec_in,
                            out_specs=spec_out, check_vma=False)(x)

    def test_left_halo_moves_neighbor_tail(self):
        mesh = make_mesh(channel=1, time=8)
        x = jnp.arange(64, dtype=jnp.float32).reshape(1, 64)
        out = self._run(
            lambda v: left_halo(v, "time", 2),
            x, (P("channel", "time"),), P("channel", "time"), mesh,
        )
        out = np.asarray(out).reshape(8, 10)
        # shard 0: zeros prepended; shard s: last 2 of shard s-1
        np.testing.assert_array_equal(out[0, :2], [0, 0])
        np.testing.assert_array_equal(out[3, :2], [22, 23])
        np.testing.assert_array_equal(out[3, 2:], np.arange(24, 32))

    def test_right_halo_moves_neighbor_head(self):
        mesh = make_mesh(channel=1, time=8)
        x = jnp.arange(64, dtype=jnp.float32).reshape(1, 64)
        out = self._run(
            lambda v: right_halo(v, "time", 3),
            x, (P("channel", "time"),), P("channel", "time"), mesh,
        )
        out = np.asarray(out).reshape(8, 11)
        np.testing.assert_array_equal(out[2, 8:], [24, 25, 26])
        np.testing.assert_array_equal(out[7, 8:], [0, 0, 0])


class TestShardedFir:
    @pytest.mark.parametrize("dec", [1, 4])
    def test_matches_streaming_fir(self, dec):
        mesh = make_mesh(channel=2, time=4)
        taps = np.asarray(_lowpass(33, 0.1))
        x = _planar((4, 4096))
        got = sharded_fir(x, taps, mesh, decimation=dec)
        # single-device streaming convention: prepend T-1 zeros
        pad = ComplexArray(
            jnp.concatenate([jnp.zeros((4, 32), jnp.float32), x.re], -1),
            jnp.concatenate([jnp.zeros((4, 32), jnp.float32), x.im], -1),
        )
        want = fir(pad, jnp.asarray(taps), dec)
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   rtol=1e-4, atol=1e-5)

    def test_with_carried_tail(self):
        mesh = make_mesh(channel=1, time=8)
        taps = np.asarray(_lowpass(17, 0.2))
        x = _planar((1, 1024))
        tail = _planar((1, 16))
        got = sharded_fir(x, taps, mesh, decimation=2, tail=tail)
        buf = ComplexArray(
            jnp.concatenate([tail.re, x.re], -1),
            jnp.concatenate([tail.im, x.im], -1),
        )
        want = fir(buf, jnp.asarray(taps), 2)
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   rtol=1e-4, atol=1e-5)


class TestShardedIir:
    @pytest.mark.parametrize("order", [1, 2, 4])
    def test_matches_single_device(self, order):
        mesh = make_mesh(channel=1, time=8)
        # stable random filter: poles well inside unit circle
        b = tuple(RNG.standard_normal(order + 1) * 0.3)
        rts = RNG.uniform(-0.6, 0.6, order)
        a_poly = np.poly(rts)
        a = tuple(a_poly.tolist())
        x = RNG.standard_normal((3, 2048)).astype(np.float32)
        zi = RNG.standard_normal((3, order)).astype(np.float32) * 0.1

        def body(x_l, zi_l):
            y, zf = sharded_iir(b, a, x_l, zi_l, "time", 8)
            return y, zf

        y, zf = shard_map_fn(
            body, mesh=mesh,
            in_specs=(P(None, "time"), P(None, None)),
            out_specs=(P(None, "time"), P(None, None)),
            check_vma=False,
        )(jnp.asarray(x), jnp.asarray(zi))

        from gsdr_tpu.ops.iir import iir_block
        want_y, want_zf = iir_block(
            jnp.asarray(b, jnp.float32), jnp.asarray(a, jnp.float32),
            jnp.asarray(x), zi=jnp.asarray(zi),
        )
        np.testing.assert_allclose(np.asarray(y), np.asarray(want_y),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(np.asarray(zf), np.asarray(want_zf),
                                   rtol=2e-3, atol=2e-4)


class TestShardedChannelizer:
    def _model(self, nch, dec=8, taps=65):
        return FmChannelizer(
            sample_rate=1_000_000.0, tuning_frequency=0.0,
            channel_frequencies=tuple(
                100_000.0 + 37_000.0 * i for i in range(nch)),
            frequency_deviation=75_000.0, decimation=dec,
            low_pass_taps=_lowpass(taps, 0.04),
        )

    @pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
    def test_fm_step_matches_single_chip(self, mesh_shape):
        c_sh, t_sh = mesh_shape
        model = self._model(nch=8)  # divisible by every channel-shard count
        mesh = make_mesh(channel=c_sh, time=t_sh)
        step = make_sharded_fm_step(model, mesh)
        rf = _planar((8192,))
        st_single = model.init()
        st_shard = model.init()
        for _ in range(2):  # two steps: exercises carried state paths
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-3, atol=2e-4)
        # carried state must agree too (continuation-equivalence)
        np.testing.assert_allclose(
            st_shard[1].to_numpy(), st_single[1].to_numpy(), atol=2e-4)
        np.testing.assert_allclose(
            np.asarray(st_shard[3]), np.asarray(st_single[3]),
            rtol=2e-3, atol=2e-4)
        assert int(st_shard[0]) == int(st_single[0])

    def test_am_step_matches_single_chip(self):
        model = AmReceiver(
            sample_rate=1_000_000.0, tuning_frequency=0.0,
            channel_frequencies=(50_000.0, -120_000.0),
            decimation=4, low_pass_taps=_lowpass(33, 0.05),
        )
        mesh = make_mesh(channel=2, time=4)
        step = make_sharded_am_step(model, mesh)
        rf = _planar((4096,))
        st_single = model.init()
        st_shard = model.init()
        for _ in range(2):
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=1e-3, atol=2e-4)


class TestShardedFusedChains:
    """The fused kernel dispatches INSIDE shard_map (in the Pallas
    interpreter on the CPU mesh), and the XLA PFB and AM fronts shard the
    same way; audio and the full carried-state pytree must match the
    single-device step."""

    def _fm_model(self, nch, impl, nt=32):
        def lp(t, c):
            n = np.arange(t) - (t - 1) / 2.0
            h = np.sinc(2 * c * n) * np.hamming(t)
            return tuple((h / h.sum()).astype(np.float32).tolist())

        return FmChannelizer(
            sample_rate=1_000_000.0, tuning_frequency=0.0,
            channel_frequencies=tuple(
                100_000.0 + 37_000.0 * i for i in range(nch)),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=lp(nt, 0.04), impl=impl,
            interpret=impl == "pallas")

    @pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (4, 1)])
    def test_fused_fm_matches_single_chip_fused(self, mesh_shape):
        c_sh, t_sh = mesh_shape
        model = self._fm_model(nch=4, impl="pallas")
        mesh = make_mesh(channel=c_sh, time=t_sh,
                         devices=jax.devices()[:c_sh * t_sh])
        step = make_sharded_fm_step(model, mesh)
        rf = _fm_rf(model.channel_frequencies, 4096)
        st_single = model.init()
        st_shard = model.init()
        for _ in range(2):  # second step exercises every carry path
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-4, atol=2e-5)
        # carried state: rf tail, disc carry, de-emphasis z, phase offset
        np.testing.assert_allclose(
            st_shard[1].to_numpy(), st_single[1].to_numpy(), atol=1e-6)
        np.testing.assert_allclose(
            st_shard[2].to_numpy(), st_single[2].to_numpy(), atol=5e-5)
        np.testing.assert_allclose(
            np.asarray(st_shard[3]), np.asarray(st_single[3]), atol=5e-5)
        assert int(st_shard[0]) == int(st_single[0])

    def test_pfb_fm_sharded_matches_single_chip(self):
        """The XLA PFB front per shard: channel shards get their own rows
        of the DFT bank; the halo/all-gather plumbing is front-agnostic."""
        import dataclasses as dc

        fs = 1_024_000.0
        k = 16
        model = FmChannelizer(
            sample_rate=fs, tuning_frequency=0.0,
            channel_frequencies=tuple(-fs / 2 + (fs / k) * i
                                      for i in range(8)),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=_lowpass(64, 0.4 / k), impl="pfb")
        mesh = make_mesh(channel=2, time=4)
        step = make_sharded_fm_step(model, mesh)
        rf = _fm_rf(model.channel_frequencies, 4096)
        st_single, st_shard = model.init(), model.init()
        for _ in range(2):
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            st_shard[1].to_numpy(), st_single[1].to_numpy(), atol=1e-6)
        np.testing.assert_allclose(
            st_shard[2].to_numpy(), st_single[2].to_numpy(), atol=5e-5)
        np.testing.assert_allclose(
            np.asarray(st_shard[3]), np.asarray(st_single[3]), atol=5e-5)
        # the fused sharded step continues the SAME stream (fronts are
        # state-compatible across the sharded boundary too)
        m_dense = dc.replace(model, impl="pallas", interpret=True)
        step_d = make_sharded_fm_step(m_dense, mesh)
        st_shard, y_mix = step_d(st_shard, rf)
        st_single, y_ref = m_dense.step(st_single, rf)
        np.testing.assert_allclose(
            np.asarray(y_mix), np.asarray(y_ref), rtol=2e-3, atol=2e-4)

    def test_fused_fm_odd_taps_sharded(self):
        """T % D != 0 (T=65, D=4) runs fused per shard."""
        model = self._fm_model(nch=4, impl="pallas", nt=65)
        mesh = make_mesh(channel=2, time=4)
        step = make_sharded_fm_step(model, mesh)
        rf = _fm_rf(model.channel_frequencies, 4096)
        st_single, st_shard = model.init(), model.init()
        for _ in range(2):
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            st_shard[1].to_numpy(), st_single[1].to_numpy(), atol=1e-6)
        np.testing.assert_allclose(
            st_shard[2].to_numpy(), st_single[2].to_numpy(), atol=5e-5)

    def test_fused_fm_interchangeable_with_xla_sharded(self):
        """A stream may switch between the fused and XLA sharded steps
        mid-flight: the state pytrees are compatible."""
        mesh = make_mesh(channel=2, time=4)
        m_p = self._fm_model(nch=4, impl="pallas")
        m_x = self._fm_model(nch=4, impl="xla")
        step_p = make_sharded_fm_step(m_p, mesh)
        step_x = make_sharded_fm_step(m_x, mesh)
        rf = _fm_rf(m_p.channel_frequencies, 8192)
        st = m_p.init()
        st, y1 = step_p(st, rf)     # fused
        st, y2 = step_x(st, rf)     # XLA continues the same stream
        st, y3 = step_p(st, rf)     # fused again
        st_r = m_x.init()
        outs = []
        for _ in range(3):          # reference: XLA on one device
            st_r, y = m_x.step(st_r, rf)
            outs.append(np.asarray(y))
        for got, want in zip([y1, y2, y3], outs):
            np.testing.assert_allclose(np.asarray(got), want,
                                       rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 2)])
    def test_xla_fm_matches_single_chip_on_fm_carriers(self, mesh_shape):
        """The XLA chain per shard on real FM carriers, at the tight
        bar: the shards' locally computed previous samples are exact."""
        c_sh, t_sh = mesh_shape
        model = self._fm_model(nch=4, impl="xla")
        mesh = make_mesh(channel=c_sh, time=t_sh,
                         devices=jax.devices()[:c_sh * t_sh])
        step = make_sharded_fm_step(model, mesh)
        rf = _fm_rf(model.channel_frequencies, 8192)
        st_single, st_shard = model.init(), model.init()
        for _ in range(2):
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            st_shard[2].to_numpy(), st_single[2].to_numpy(), atol=5e-5)

    def test_pfb_am_sharded_matches_single_chip(self):
        """The XLA PFB-fronted AM chain per shard."""
        fs = 1_024_000.0
        k = 16
        model = AmReceiver(
            sample_rate=fs, tuning_frequency=0.0,
            channel_frequencies=tuple(-fs / 2 + (fs / k) * i
                                      for i in range(8)),
            decimation=8, low_pass_taps=_lowpass(64, 0.4 / k),
            impl="pfb")
        mesh = make_mesh(channel=2, time=4)
        step = make_sharded_am_step(model, mesh)
        rf = _planar((4096,))
        st_single, st_shard = model.init(), model.init()
        for _ in range(2):
            st_single, y_single = model.step(st_single, rf)
            st_shard, y_shard = step(st_shard, rf)
        np.testing.assert_allclose(
            np.asarray(y_shard), np.asarray(y_single), rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("impl", ["pallas", "pfb_pallas"])
    def test_am_kernel_impls_removed(self, impl):
        with pytest.raises(ValueError, match="unknown impl"):
            AmReceiver(sample_rate=1_000_000.0, tuning_frequency=0.0,
                       channel_frequencies=(50_000.0,), decimation=4,
                       low_pass_taps=_lowpass(32, 0.05), impl=impl)

    def test_channels_must_split_over_shards(self):
        model = self._fm_model(nch=3, impl="xla")
        with pytest.raises(ValueError, match="channel shards"):
            make_sharded_fm_step(model, make_mesh(channel=2, time=4))


class TestShardedModems:
    def test_qpsk256_sharded_loopback(self):
        from gsdr_tpu.parallel.modem import make_sharded_qpsk256_modem
        from gsdr_tpu.pipelines import Qpsk256Modem

        mesh = make_mesh(channel=4, time=2)
        modem = Qpsk256Modem(amplitude=1.0)
        tx, rx = make_sharded_qpsk256_modem(modem, mesh)
        syms = RNG.integers(0, 256, size=(8, 512)).astype(np.int32)
        out = np.asarray(jax.jit(lambda s: rx(tx(s)))(jnp.asarray(syms)))
        np.testing.assert_array_equal(out, syms)

    def test_qpsk_sharded_loopback(self):
        from gsdr_tpu.parallel.modem import make_sharded_qpsk_modem
        from gsdr_tpu.pipelines import QpskModem

        mesh = make_mesh(channel=2, time=4)
        modem = QpskModem(amplitude=2.0)
        tx, rx = make_sharded_qpsk_modem(modem, mesh)
        syms = RNG.integers(0, 4, size=(4, 1024)).astype(np.int32)
        out = np.asarray(jax.jit(lambda s: rx(tx(s)))(jnp.asarray(syms)))
        np.testing.assert_array_equal(out, syms)

    def test_qpsk_sharded_tx_is_gather_free_and_bit_identical(self):
        """The sharded tx uses the sign-arithmetic modulator (ops/qpsk.py):
        no gather, bit-identical to the single-device op."""
        from gsdr_tpu.ops.qpsk import qpsk_modulate_symbols
        from gsdr_tpu.parallel.modem import make_sharded_qpsk_modem
        from gsdr_tpu.pipelines import QpskModem

        mesh = make_mesh(channel=2, time=4)
        modem = QpskModem(amplitude=2.0)
        tx, _ = make_sharded_qpsk_modem(modem, mesh)
        syms = jnp.asarray(RNG.integers(0, 4, size=(4, 1024)), jnp.int32)
        hlo = jax.jit(tx).lower(syms).as_text()
        assert "gather" not in hlo and "dynamic_slice" not in hlo, hlo[:2000]
        got = tx(syms)
        want = qpsk_modulate_symbols(syms, 2.0)
        np.testing.assert_array_equal(np.asarray(got.re), np.asarray(want.re))
        np.testing.assert_array_equal(np.asarray(got.im), np.asarray(want.im))


class TestMultihost:
    def test_pod_mesh_single_host_layout(self):
        from gsdr_tpu.parallel import make_pod_mesh

        mesh = make_pod_mesh(channel_per_host=2)
        assert mesh.axis_names == ("channel", "time")
        assert mesh.shape["channel"] == 2
        assert mesh.shape["time"] == 4

    def test_pod_mesh_runs_sharded_step(self):
        from gsdr_tpu.parallel import make_pod_mesh
        from gsdr_tpu.pipelines import FmChannelizer

        mesh = make_pod_mesh(channel_per_host=2)
        model = FmChannelizer(
            sample_rate=1_000_000.0, tuning_frequency=0.0,
            channel_frequencies=(100_000.0, -50_000.0),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=_lowpass(33, 0.04),
        )
        step = make_sharded_fm_step(model, mesh)
        rf = _planar((4096,))
        st, audio = step(model.init(), rf)
        assert np.asarray(audio).shape == (2, 1024)
