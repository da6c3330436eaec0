"""Streaming layer: block-wise processing must equal whole-signal processing.

The invariant under test is the one the reference delegates to callers via
overlap/firstSampleIndex contracts (include/gsdr/fm.h:26,
src/adjustFrequency.cuh:25): splitting a stream into blocks must not change
the output. Here the framework carries the state, so the invariant is
checked end-to-end: concat(stream outputs) == single-shot output.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gsdr_tpu import fir, freq_shift, iir, quad_fm_demod
from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.stream import (
    Chain,
    FirStream,
    IirStream,
    MixerStream,
    QuadFmStream,
)

RNG = np.random.default_rng(1234)


def _blocks(x, block_len):
    n = x.shape[-1] // block_len
    return [x[..., i * block_len:(i + 1) * block_len] for i in range(n)]


def _planar(n, lead=()):
    z = RNG.standard_normal(lead + (n,)) + 1j * RNG.standard_normal(lead + (n,))
    return ComplexArray.from_complex(z.astype(np.complex64))


def _cat(outs):
    if isinstance(outs[0], ComplexArray):
        return ComplexArray(
            jnp.concatenate([o.re for o in outs], axis=-1),
            jnp.concatenate([o.im for o in outs], axis=-1),
        )
    return jnp.concatenate(outs, axis=-1)


class TestMixerStream:
    def test_matches_single_shot(self):
        n, bl = 4096, 512
        x = _planar(n)
        op = MixerStream(freq_shift_hz=12_345.0, sample_rate=1_000_000.0)
        st = op.init()
        outs = []
        for blk in _blocks(x, bl):
            st, y = op.step(st, blk)
            outs.append(y)
        got = _cat(outs).to_numpy()
        want = freq_shift(x, 12_345.0, 1_000_000.0).to_numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_offset_continuity_across_fs_wrap(self):
        # Stream long enough that the carried offset wraps mod Fs.
        fs = 10_000.0
        op = MixerStream(freq_shift_hz=777.0, sample_rate=fs)
        st = op.init(first_sample_index=9_000)
        x = _planar(4096)
        st, y1 = op.step(st, x)
        # same result as a single-shot with the global first index
        want = freq_shift(x, 777.0, fs, first_sample_index=9_000).to_numpy()
        np.testing.assert_allclose(y1.to_numpy(), want, atol=2e-4)
        assert int(st) == (9_000 + 4096) % 10_000

    def test_fractional_shift_exact_across_wrap(self):
        # A non-integral shift frequency used to
        # jump by frac(f) cycles every Fs samples (state wrapped mod
        # round(Fs)). Now the wrap modulus is the EXACT period of
        # frac(f*n/Fs): f=0.5 at Fs=1000 has period 2000 — with the old
        # modulus the LO flipped sign at each wrap. Stream long past the
        # period and compare against the single-shot global-index LO.
        fs = 1000.0
        op = MixerStream(freq_shift_hz=0.5, sample_rate=fs)
        assert op._wrap_modulus() == 2000
        n, bl = 6000, 1500  # crosses n=1000, 2000 (the old + new wraps)
        x = _planar(n)
        st = op.init()
        outs = []
        for blk in _blocks(x, bl):
            st, y = op.step(st, blk)
            outs.append(y)
        got = _cat(outs).to_numpy()
        want = freq_shift(x, 0.5, fs).to_numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_unrepresentable_period_warns_at_construction(self):
        # float 0.1 is not 1/10 — the exact f/Fs period exceeds the int32
        # index budget, so construction must warn loudly instead of
        # silently jumping phase.
        with pytest.warns(UserWarning, match="APPROXIMATE"):
            MixerStream(freq_shift_hz=0.1, sample_rate=1000.0)

    def test_integral_shift_at_wide_fs_does_not_warn(self):
        # round-5 review: an integral shift at an integral Fs > 2^24 has
        # a reduced denominator too large to use as the modulus, but
        # round(Fs) is still an exact period — no warning, and the wrap
        # stays at Fs (the legacy-exact case).
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            op = MixerStream(freq_shift_hz=1.0, sample_rate=20_000_000.0)
        assert op._wrap_modulus() == 20_000_000
        assert op._wrap_is_exact()


class TestFirStream:
    @pytest.mark.parametrize("dec", [1, 2, 4])
    def test_matches_zero_primed_full(self, dec):
        taps = tuple(RNG.standard_normal(33).astype(np.float32).tolist())
        op = FirStream(taps=taps, decimation=dec)
        n, bl = 2048, 256
        x = _planar(n, lead=(3,))
        st = op.init(x[..., :bl])
        outs = []
        for blk in _blocks(x, bl):
            st, y = op.step(st, blk)
            outs.append(y)
        got = _cat(outs).to_numpy()
        assert got.shape[-1] == n // dec
        # equivalent single shot: prepend T-1 zeros
        pad = ComplexArray(
            jnp.concatenate([jnp.zeros((3, 32), jnp.float32), x.re], -1),
            jnp.concatenate([jnp.zeros((3, 32), jnp.float32), x.im], -1),
        )
        want = fir(pad, jnp.asarray(taps), dec).to_numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_tail_carries_decimation_phase(self):
        # Two consecutive blocks must land on the same global i*D grid.
        taps = tuple(np.ones(8, np.float32) / 8.0)
        op = FirStream(taps=taps, decimation=4)
        x = _planar(512)
        st = op.init(x[..., :256])
        st, y1 = op.step(st, x[..., :256])
        st, y2 = op.step(st, x[..., 256:])
        got = np.concatenate([y1.to_numpy(), y2.to_numpy()])
        pad = ComplexArray(
            jnp.concatenate([jnp.zeros(7, jnp.float32), x.re], -1),
            jnp.concatenate([jnp.zeros(7, jnp.float32), x.im], -1),
        )
        want = fir(pad, jnp.asarray(taps), 4).to_numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestIirStream:
    def test_matches_full(self):
        b = (0.2, 0.3, 0.1)
        a = (1.0, -0.4, 0.2)
        op = IirStream(b=b, a=a)
        x = RNG.standard_normal((2, 1024)).astype(np.float32)
        st = op.init(jnp.asarray(x[..., :128]))
        outs = []
        for blk in _blocks(jnp.asarray(x), 128):
            st, y = op.step(st, blk)
            outs.append(y)
        got = np.concatenate(outs, axis=-1)
        want = np.asarray(iir(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


class TestQuadFmStream:
    def test_matches_zero_primed_full(self):
        op = QuadFmStream(gain=2.5)
        x = _planar(1024)
        st = op.init(x[..., :256])
        outs = []
        for blk in _blocks(x, 256):
            st, y = op.step(st, blk)
            outs.append(y)
        got = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        assert got.shape[-1] == 1024  # N outputs for N inputs (carried halo)
        full = ComplexArray(
            jnp.concatenate([jnp.zeros(1, jnp.float32), x.re], -1),
            jnp.concatenate([jnp.zeros(1, jnp.float32), x.im], -1),
        )
        want = np.asarray(quad_fm_demod(full, 2.5))
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert got[0] == 0.0  # atan2(0, 0) warmup artifact, documented


class TestChain:
    def test_mix_fir_disc_chain(self):
        taps = tuple((np.ones(16, np.float32) / 16.0).tolist())
        chain = Chain(stages=(
            MixerStream(freq_shift_hz=1000.0, sample_rate=48_000.0),
            FirStream(taps=taps, decimation=2),
            QuadFmStream(gain=1.0),
        ))
        x = _planar(2048)
        st = chain.init(x[..., :512])
        outs = []
        for blk in _blocks(x, 512):
            st, y = chain.step(st, blk)
            outs.append(y)
        got = np.concatenate([np.asarray(o) for o in outs], axis=-1)
        assert got.shape == (1024,)

        # equivalent single shot
        mixed = freq_shift(x, 1000.0, 48_000.0)
        pad = ComplexArray(
            jnp.concatenate([jnp.zeros(15, jnp.float32), mixed.re], -1),
            jnp.concatenate([jnp.zeros(15, jnp.float32), mixed.im], -1),
        )
        filt = fir(pad, jnp.asarray(taps), 2)
        full = ComplexArray(
            jnp.concatenate([jnp.zeros(1, jnp.float32), filt.re], -1),
            jnp.concatenate([jnp.zeros(1, jnp.float32), filt.im], -1),
        )
        want = np.asarray(quad_fm_demod(full, 1.0))
        np.testing.assert_allclose(got, want, atol=5e-4)

    def test_state_is_checkpointable(self):
        # Saving + restoring the state pytree resumes bit-exactly.
        import jax

        taps = tuple((np.ones(8, np.float32) / 8.0).tolist())
        chain = Chain(stages=(
            MixerStream(freq_shift_hz=500.0, sample_rate=8000.0),
            FirStream(taps=taps, decimation=1),
        ))
        x = _planar(1024)
        st = chain.init(x[..., :256])
        blocks = _blocks(x, 256)
        st, _ = chain.step(st, blocks[0])
        snapshot = jax.tree_util.tree_map(lambda l: np.asarray(l).copy(), st)
        _, y_direct = chain.step(st, blocks[1])
        restored = jax.tree_util.tree_map(jnp.asarray, snapshot)
        _, y_restored = chain.step(restored, blocks[1])
        np.testing.assert_array_equal(
            y_direct.to_numpy(), y_restored.to_numpy()
        )


class TestScanStream:
    def test_matches_python_loop(self):
        from gsdr_tpu.stream import scan_stream
        import jax

        taps = tuple((np.ones(16, np.float32) / 16.0).tolist())
        chain = Chain(stages=(
            MixerStream(freq_shift_hz=1000.0, sample_rate=48_000.0),
            FirStream(taps=taps, decimation=2),
        ))
        x = _planar(4096)
        blocks = ComplexArray(x.re.reshape(8, 512), x.im.reshape(8, 512))
        st0 = chain.init(x[..., :512])
        # python loop
        st, outs = st0, []
        for i in range(8):
            st, y = chain.step(st, blocks[i])
            outs.append(y.to_numpy())
        want = np.stack(outs)
        # one jitted scan
        st2, got = jax.jit(
            lambda s, b: scan_stream(chain.step, s, b))(st0, blocks)
        np.testing.assert_allclose(got.to_numpy(), want, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(st2[0]), np.asarray(st[0]), atol=0)

    def test_channelizer_scan(self):
        from gsdr_tpu.stream import scan_stream
        from gsdr_tpu.pipelines import FmChannelizer
        import jax

        def lowpass(nt, cf):
            n = np.arange(nt) - (nt - 1) / 2.0
            h = np.sinc(2 * cf * n) * np.hamming(nt)
            return tuple((h / h.sum()).astype(np.float32).tolist())

        model = FmChannelizer(
            sample_rate=1_000_000.0, tuning_frequency=0.0,
            channel_frequencies=(100_000.0,), frequency_deviation=75_000.0,
            decimation=4, low_pass_taps=lowpass(33, 0.04))
        x = _planar(8192)
        blocks = ComplexArray(x.re.reshape(2, 4096), x.im.reshape(2, 4096))
        st, audio = jax.jit(
            lambda s, b: scan_stream(model.step, s, b))(model.init(), blocks)
        assert np.asarray(audio).shape == (2, 1, 1024)
