"""Checkpoint utility and CLI tools."""

import numpy as np
import jax.numpy as jnp

from gsdr_tpu.pipelines import FmChannelizer
from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.utils.checkpoint import load_state, save_state

RNG = np.random.default_rng(11)


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _model():
    return FmChannelizer(
        sample_rate=100_000.0, tuning_frequency=0.0,
        channel_frequencies=(10_000.0, -20_000.0),
        frequency_deviation=5_000.0, decimation=4,
        low_pass_taps=_lowpass(33, 0.05),
    )


def _planar(n):
    z = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    return ComplexArray.from_complex(z.astype(np.complex64))


class TestCheckpoint:
    def test_save_load_resumes_bit_exact(self, tmp_path):
        model = _model()
        rf = _planar(4096)
        st = model.init()
        st, _ = model.step(st, rf[..., :2048])
        path = str(tmp_path / "state.npz")
        save_state(path, st)
        restored = load_state(path, model.init())
        _, y_direct = model.step(st, rf[..., 2048:])
        _, y_restored = model.step(restored, rf[..., 2048:])
        np.testing.assert_array_equal(np.asarray(y_direct),
                                      np.asarray(y_restored))

    def test_shape_mismatch_rejected(self, tmp_path):
        model = _model()
        path = str(tmp_path / "state.npz")
        save_state(path, model.init())
        other = FmChannelizer(
            sample_rate=100_000.0, tuning_frequency=0.0,
            channel_frequencies=(10_000.0,),  # 1 channel != 2
            frequency_deviation=5_000.0, decimation=4,
            low_pass_taps=_lowpass(33, 0.05),
        )
        try:
            load_state(path, other.init())
            raise AssertionError("expected shape mismatch")
        except ValueError:
            pass


class TestFmRxCli:
    def test_end_to_end(self, tmp_path):
        from gsdr_tpu.tools import fm_rx

        fs = 128_000.0
        n = 1 << 15
        t = np.arange(n) / fs
        tone, dev, fc = 800.0, 3000.0, 20_000.0
        rf = np.exp(1j * (2 * np.pi * fc * t
                          + (dev / tone) * np.sin(2 * np.pi * tone * t)))
        inter = np.empty(2 * n, np.float32)
        inter[0::2] = rf.real * 0.8
        inter[1::2] = rf.imag * 0.8
        raw = np.clip(np.round(inter * 127), -127, 127).astype(np.int8)
        iq = tmp_path / "in.iq"
        iq.write_bytes(raw.tobytes())
        out = tmp_path / "audio.f32"
        state_file = tmp_path / "st.npz"
        fm_rx.main([
            str(iq), "-o", str(out), "--fs", str(fs),
            "--channels", str(fc), "--deviation", str(dev),
            "--decim", "4", "--taps", "65", "--block", "8192",
            "--save-state", str(state_file),
        ])
        audio = np.frombuffer(out.read_bytes(), np.float32)
        assert len(audio) == (n // 8192) * 2048
        a = audio[300:] - audio[300:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        peak_hz = (np.argmax(spec[5:]) + 5) * (fs / 4) / len(a)
        assert abs(peak_hz - tone) < 40.0, peak_hz
        assert state_file.exists()


def test_fm_rx_cli_with_audio_resample(tmp_path):
    from gsdr_tpu.tools import fm_rx

    fs = 128_000.0
    n = 1 << 14
    t = np.arange(n) / fs
    tone, dev, fc = 800.0, 3000.0, 20_000.0
    rf = np.exp(1j * (2 * np.pi * fc * t
                      + (dev / tone) * np.sin(2 * np.pi * tone * t)))
    inter = np.empty(2 * n, np.float32)
    inter[0::2] = rf.real * 0.8
    inter[1::2] = rf.imag * 0.8
    iq = tmp_path / "in.iq"
    iq.write_bytes(np.clip(np.round(inter * 127), -127, 127)
                   .astype(np.int8).tobytes())
    out = tmp_path / "audio48.f32"
    fm_rx.main([
        str(iq), "-o", str(out), "--fs", str(fs), "--channels", str(fc),
        "--deviation", str(dev), "--decim", "4", "--taps", "65",
        "--block", "8192", "--audio-rate", "48000",
    ])
    audio = np.frombuffer(out.read_bytes(), np.float32)
    # 32 kHz audio -> 48 kHz: 3/2 resampling per 2048-sample block
    assert len(audio) > 0
    a = audio[500:] - audio[500:].mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    peak_hz = (np.argmax(spec[5:]) + 5) * 48_000.0 / len(a)
    assert abs(peak_hz - tone) < 40.0, peak_hz


def test_throughput_report_structure():
    import jax.numpy as jnp
    from gsdr_tpu.utils.profiling import throughput_report

    def step(st, x):
        return st + jnp.sum(x) * 1e-30, x * 2.0

    # checks structure, not precision: the CPU gives no device metric
    rep = throughput_report(step, jnp.zeros(()), jnp.ones(1024),
                            samples_per_step=1024, iters=3, label="x2")
    assert rep["label"] == "x2"
    assert rep["samples_per_second"] > 0
    assert rep["msamples_per_second"] == rep["samples_per_second"] / 1e6
    assert rep["device"]["platform"] == "cpu"
