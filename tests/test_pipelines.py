"""Pipeline models: FM channelizer, AM receiver, QPSK modems.

Correctness bars mirror the reference test intent (SURVEY.md section 4):
physics sanity (a pure carrier at channel center demodulates to ~DC), block
invariance (streaming == single shot), and modem loopback/BER bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.pipelines import (
    AmReceiver,
    FmChannelizer,
    QpskModem,
    Qpsk256Modem,
    fm_deemphasis_coeffs,
)
from gsdr_tpu.ops.qpsk import pack_2bit_symbols, unpack_2bit_symbols
from gsdr_tpu.ops.qpsk256 import CIRCULAR, RECTANGULAR

RNG = np.random.default_rng(99)
FS = 1_000_000.0


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _fm_signal(freqs_hz, deviation, audio_hz, fs, n):
    """Sum of FM carriers at freqs_hz each modulated by a audio_hz tone."""
    t = np.arange(n) / fs
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(freqs_hz):
        msg = np.sin(2 * np.pi * audio_hz * (k + 1) * t)
        phase = 2 * np.pi * f * t + deviation / (audio_hz * (k + 1)) * (
            -np.cos(2 * np.pi * audio_hz * (k + 1) * t) + 1.0
        )
        sig += 0.5 * np.exp(1j * phase)
    return ComplexArray.from_complex(sig.astype(np.complex64))


def _make_channelizer(nch=4, dec=8, taps=65):
    chans = tuple(100_000.0 + 50_000.0 * i for i in range(nch))
    return FmChannelizer(
        sample_rate=FS,
        tuning_frequency=0.0,
        channel_frequencies=chans,
        frequency_deviation=75_000.0,
        decimation=dec,
        low_pass_taps=_lowpass(taps, 0.04),
    )


class TestFmChannelizer:
    def test_shapes_and_block_invariance(self):
        model = _make_channelizer()
        n, bl = 8192, 2048
        rf = _fm_signal([-f for f in model.channel_frequencies][:2],
                        50_000.0, 1000.0, FS, n)
        # single shot
        st = model.init()
        _, audio_full = model.step(st, rf)
        assert audio_full.shape == (4, n // model.decimation)
        # blockwise
        st = model.init()
        outs = []
        for i in range(n // bl):
            st, y = model.step(st, rf[..., i * bl:(i + 1) * bl])
            outs.append(np.asarray(y))
        got = np.concatenate(outs, axis=-1)
        np.testing.assert_allclose(got, np.asarray(audio_full),
                                   rtol=1e-4, atol=1e-4)

    def test_tone_recovery(self):
        """Each channel's audio must contain its own modulating tone."""
        model = _make_channelizer(nch=2, dec=16, taps=129)
        n = 1 << 15
        dev = 5_000.0  # keep per-decimated-sample phase step well under pi
        audio_hz = 2_000.0
        # channel freqs as seen in baseband: tuning 0, channel at +100k/+150k
        rf = _fm_signal([100_000.0, 150_000.0], dev, audio_hz, FS, n)
        model = FmChannelizer(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=(100_000.0, 150_000.0),
            frequency_deviation=dev, decimation=16,
            low_pass_taps=_lowpass(129, 0.02),
        )
        st = model.init()
        _, audio = model.step(st, rf)
        audio = np.asarray(audio)
        arate = FS / 16
        for c in range(2):
            a = audio[c][200:]  # drop filter warmup
            spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
            peak_hz = np.argmax(spec[5:]) + 5  # skip DC leakage bins
            peak_hz *= arate / len(a)
            want = audio_hz * (c + 1)
            assert abs(peak_hz - want) < 150.0, (c, peak_hz, want)

    def test_constant_carrier_gives_near_dc(self):
        """Unmodulated carrier at channel center -> discriminator ~0
        (reference physics check, tests/test_quad_demod.cpp:99-115)."""
        model = _make_channelizer(nch=1, dec=8)
        n = 8192
        t = np.arange(n)
        rf = ComplexArray.from_complex(
            np.exp(2j * np.pi * model.channel_frequencies[0] * t / FS)
            .astype(np.complex64))
        st = model.init()
        _, audio = model.step(st, rf)
        a = np.asarray(audio)[0][50:]
        assert np.max(np.abs(a)) < 1e-2

    def test_deemphasis_coeffs_dc_gain(self):
        b, a = fm_deemphasis_coeffs(75e-6, 48_000.0)
        # unity DC gain: sum(b)/sum(a) == 1
        assert abs(sum(b) / sum(a) - 1.0) < 1e-9

    def test_deemphasis_unstable_region_raises(self):
        """Past the bilinear prewarp limit (tau <= 1/(pi*audio_rate))
        the mapped pole leaves the unit circle — round 5 hit this at a
        4-kHz audio rate with the US 75-us tau (outputs diverged to
        ~1e21); the constructor must fail loudly instead."""
        import pytest

        with pytest.raises(ValueError, match="unstable"):
            fm_deemphasis_coeffs(75e-6, 4000.0)
        # just inside the limit: fine and stable
        b, a = fm_deemphasis_coeffs(90e-6, 4000.0)
        assert abs(a[1]) < 1.0

    @pytest.mark.parametrize("tau", [0.0, -75e-6, -1.0])
    def test_deemphasis_nonpositive_tau_raises(self, tau):
        """tau <= 0 builds no filter: zero divided by zero, a negative
        tau an unstable pole. Both raise ValueError."""
        import pytest

        with pytest.raises(ValueError, match="positive"):
            fm_deemphasis_coeffs(tau, 48_000.0)

    @pytest.mark.parametrize("n", [5000, 1024])
    def test_fused_pad_and_mask_matches_xla(self, n):
        """The fused FM kernel runs any block length (its program grid
        starts before output 0 and ends on output M-1). Audio AND carried
        state must match the XLA chain across two steps."""
        import dataclasses

        model = FmChannelizer(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=(100_000.0, -50_000.0, 37_000.0),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=_lowpass(32, 0.04))
        mx = dataclasses.replace(model, impl="xla")
        mp = dataclasses.replace(model, impl="pallas", interpret=True)
        # real FM carriers, not white noise: noise puts samples on the
        # atan2 +-pi branch cut where two correct implementations may
        # differ by 2*pi
        t = np.arange(n) / FS
        sig = np.zeros(n, np.complex128)
        for k, f in enumerate(model.channel_frequencies):
            msg = np.sin(2 * np.pi * 900.0 * (k + 1) * t)
            sig += 0.3 * np.exp(1j * (2 * np.pi * f * t + 0.4 * msg))
        rf = ComplexArray.from_complex(sig.astype(np.complex64))
        stx, stp = mx.init(), mp.init()
        for _ in range(2):
            stx, yx = mx.step(stx, rf)
            stp, yp = mp.step(stp, rf)
        yx, yp = np.asarray(yx), np.asarray(yp)
        assert yx.shape == yp.shape == (3, n // 4)
        scale = np.max(np.abs(yx)) + 1e-12
        assert np.max(np.abs(yx - yp)) / scale < 2e-4
        np.testing.assert_allclose(stp[2].to_numpy(), stx[2].to_numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(stp[3]), np.asarray(stx[3]),
                                   atol=1e-4)


class TestAmReceiver:
    def test_envelope_recovery(self):
        n = 1 << 14
        t = np.arange(n) / FS
        carrier_f = 120_000.0
        mod = 0.5 * np.sin(2 * np.pi * 1500.0 * t)
        rf_c = (0.45 * (1.0 + mod)) * np.exp(2j * np.pi * carrier_f * t)
        rf = ComplexArray.from_complex(rf_c.astype(np.complex64))
        model = AmReceiver(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=(carrier_f,),
            decimation=8, low_pass_taps=_lowpass(65, 0.04),
        )
        st = model.init()
        _, audio = model.step(st, rf)
        a = np.asarray(audio)[0][50:]
        arate = FS / 8
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak = (np.argmax(spec[5:]) + 5) * arate / len(a)
        assert abs(peak - 1500.0) < 100.0

    def test_block_invariance(self):
        model = AmReceiver(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=(-50_000.0, 75_000.0),
            decimation=4, low_pass_taps=_lowpass(33, 0.05),
        )
        n, bl = 4096, 1024
        z = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
        rf = ComplexArray.from_complex(0.2 * z.astype(np.complex64))
        st = model.init()
        _, full = model.step(st, rf)
        st = model.init()
        outs = []
        for i in range(n // bl):
            st, y = model.step(st, rf[..., i * bl:(i + 1) * bl])
            outs.append(np.asarray(y))
        np.testing.assert_allclose(
            np.concatenate(outs, -1), np.asarray(full), rtol=1e-4, atol=1e-5
        )


class TestQpskModem:
    def test_ideal_loopback_bit_exact(self):
        modem = QpskModem(amplitude=2.0)
        data = RNG.integers(0, 256, size=256).astype(np.int32)
        out = np.asarray(modem.loopback(jnp.asarray(data)))
        np.testing.assert_array_equal(out, data)

    def test_awgn_ber_below_1pct_at_10db(self):
        """Reference quality bar: BER < 1% at 10 dB SNR
        (tests/test_qpsk.cpp:172-210)."""
        modem = QpskModem(amplitude=1.0)
        nbytes = 4096
        data = RNG.integers(0, 256, size=nbytes).astype(np.int32)
        tx = modem.tx(jnp.asarray(data))
        es = 2.0  # |(+-1, +-1)|^2
        snr_db = 10.0
        sigma = np.sqrt(es / (2.0 * 10 ** (snr_db / 10.0)))
        noise_re = RNG.standard_normal(tx.shape).astype(np.float32) * sigma
        noise_im = RNG.standard_normal(tx.shape).astype(np.float32) * sigma
        rx_in = ComplexArray(tx.re + noise_re, tx.im + noise_im)
        out = np.asarray(modem.rx(rx_in))
        bits_tx = np.unpackbits(data.astype(np.uint8)[:, None], axis=1)
        bits_rx = np.unpackbits(out.astype(np.uint8)[:, None], axis=1)
        ber = np.mean(bits_tx != bits_rx)
        assert ber < 0.01, ber

    def test_multichannel_axis(self):
        modem = QpskModem()
        data = RNG.integers(0, 256, size=(8, 64)).astype(np.int32)
        out = np.asarray(modem.loopback(jnp.asarray(data)))
        np.testing.assert_array_equal(out, data)


class TestQpsk256Modem:
    @pytest.mark.parametrize("ctype", [RECTANGULAR, CIRCULAR])
    def test_ideal_loopback_symbol_exact(self, ctype):
        modem = Qpsk256Modem(constellation_type=ctype, amplitude=1.5)
        syms = RNG.integers(0, 256, size=2048).astype(np.int32)
        out = np.asarray(modem.loopback(jnp.asarray(syms)))
        np.testing.assert_array_equal(out, syms)

    def test_rect_ser_under_awgn_high_snr(self):
        modem = Qpsk256Modem(constellation_type=RECTANGULAR, amplitude=1.0)
        syms = RNG.integers(0, 256, size=8192).astype(np.int32)
        tx = modem.tx(jnp.asarray(syms))
        sigma = 0.01
        rx_in = ComplexArray(
            tx.re + RNG.standard_normal(tx.shape).astype(np.float32) * sigma,
            tx.im + RNG.standard_normal(tx.shape).astype(np.float32) * sigma,
        )
        out = np.asarray(modem.rx(rx_in))
        ser = np.mean(out != syms)
        assert ser < 0.001, ser
