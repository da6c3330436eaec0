"""Polyphase FFT channelizer vs the generic complex-tap-bank channelizer.

The PFB must reproduce channelize() exactly (same windows, uniform grid,
critical decimation) — it is the fast path, not a different filter.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.channelize import channelize
from gsdr_tpu.ops.pfb import pfb_channelize, pfb_taps_to_polyphase

RNG = np.random.default_rng(23)
FS = 1_024_000.0


def _planar(n):
    z = RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
    return ComplexArray.from_complex(z.astype(np.complex64))


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


@pytest.mark.parametrize("k,q", [(16, 8), (8, 4), (64, 4)])
def test_matches_generic_channelizer(k, q):
    taps = _lowpass(k * q, 0.4 / k)
    x = _planar(k * 64 + k * q)
    got = pfb_channelize(x, taps, k)
    # generic path: channel c at +c*Fs/K => shift = -c*Fs/K, decimation K
    shifts = [-(c * FS / k) for c in range(k)]
    want = channelize(x, taps, shifts, FS, decimation=k)
    assert got.shape == want.shape
    scale = np.max(np.abs(want.to_numpy()))
    np.testing.assert_allclose(
        got.to_numpy(), want.to_numpy(), atol=2e-4 * max(scale, 1.0))


def test_tone_lands_in_its_channel():
    k, q = 16, 8
    taps = _lowpass(k * q, 0.4 / k)
    n = 1 << 14
    t = np.arange(n)
    c_target = 5
    tone = np.exp(2j * np.pi * (c_target / k) * t).astype(np.complex64)
    x = ComplexArray.from_complex(tone)
    out = pfb_channelize(x, taps, k)
    power = np.mean(np.abs(out.to_numpy()) ** 2, axis=-1)
    assert np.argmax(power) == c_target
    others = np.delete(power, c_target)
    assert power[c_target] > 100 * np.max(others)


def test_polyphase_decomposition_shape():
    poly = pfb_taps_to_polyphase(np.arange(12, dtype=np.float32), 4)
    assert poly.shape == (4, 3)
    # row r = taps[r], taps[r+K], taps[r+2K]
    np.testing.assert_array_equal(poly[1], [1.0, 5.0, 9.0])


@pytest.mark.parametrize("k,q", [(16, 8), (8, 4)])
def test_dense_bank_matches_pfb(k, q):
    """The uniform grid is a complex-tap bank with g_c[t] = h[t]
    e^{-2i pi ct/K} at decimation K (the rotor is 1 at critical
    decimation): the dense conv bank must agree with the fold + DFT."""
    from gsdr_tpu.ops.channelize import (
        make_complex_tap_bank,
        mix_fir_decimate_bank,
    )

    taps = _lowpass(k * q, 0.4 / k)
    x = _planar(k * 256 + k * q)
    want = pfb_channelize(x, taps, k)
    bank = make_complex_tap_bank(taps, [-c for c in range(k)], k)
    got = mix_fir_decimate_bank(x, bank, k)
    assert got.shape == want.shape
    scale = np.max(np.abs(want.to_numpy()))
    np.testing.assert_allclose(
        got.to_numpy(), want.to_numpy(), atol=3e-4 * max(scale, 1.0))


class TestUniformGridBank:
    """Round-4 oversampled uniform-grid front-end: fold + DFT-bank matmul
    must reproduce the dense complex-tap-bank conv exactly (same windows,
    any D | K, any tap count)."""

    def test_uniform_grid_detection(self):
        from gsdr_tpu.ops.pfb import uniform_grid

        k, bins = uniform_grid([0.0, FS / 64, -FS / 64, 5 * FS / 64], FS)
        assert k == 64 and bins == [0, 1, 63, 5]
        k, bins = uniform_grid([FS / 4], FS)
        assert k == 4 and bins == [1]
        # non-grid spacing (the run_all fm64 config class): Fs/15000 is
        # not rational with a small denominator -> detected, but too big
        assert uniform_grid([15_000.0, 30_000.0], 1e6)[0] == 200
        assert uniform_grid([1234.5678], FS, max_k=4096) is None

    @pytest.mark.parametrize("c,k,d,t", [
        (16, 16, 16, 128),   # critical, Q=8
        (16, 16, 4, 128),    # 4x oversampled
        (64, 64, 16, 512),   # wideband: 64 channels, Q=8
        (8, 16, 8, 65),      # C < K, odd T (zero-pad), non-contig bins
        (4, 8, 2, 24),       # small everything
    ])
    def test_matches_dense_bank(self, c, k, d, t):
        from gsdr_tpu.ops.channelize import (
            make_complex_tap_bank,
            mix_fir_decimate_bank,
        )
        from gsdr_tpu.ops.pfb import mix_fir_decimate_bank_uniform

        bins = [(3 * i + 1) % k for i in range(c)]
        shifts = [b * FS / k for b in bins]
        taps = _lowpass(t, 0.4 / k)
        x = _planar(k * 40 + t)
        want = mix_fir_decimate_bank(
            x, make_complex_tap_bank(taps, shifts, FS), d)
        got = mix_fir_decimate_bank_uniform(x, taps, bins, k, d)
        assert got.shape == want.shape, (got.shape, want.shape)
        scale = np.max(np.abs(want.to_numpy()))
        np.testing.assert_allclose(
            got.to_numpy(), want.to_numpy(), atol=1e-5 * max(scale, 1.0))

    def test_model_pfb_impl_matches_xla(self):
        """FmChannelizer(impl='pfb') streams identically to impl='xla'
        (same state pytree, same audio) on a grid config."""
        import dataclasses as dc

        from gsdr_tpu.pipelines import FmChannelizer

        k = 32
        m = FmChannelizer(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=tuple(-FS / 2 + (FS / k) * i
                                      for i in range(k)),
            frequency_deviation=75_000.0, decimation=8,
            low_pass_taps=tuple(_lowpass(4 * k, 0.4 / k).tolist()),
            impl="xla")
        mp = dc.replace(m, impl="pfb")
        n = 8192
        tt = np.arange(2 * n) / FS
        sig = np.zeros(2 * n, np.complex128)
        # a carrier on EVERY channel: silent channels demodulate near-zero
        # filtered samples whose atan2 phase is branch-cut ill-posed
        # between two correct implementations
        for c in range(k):
            msg = np.sin(2 * np.pi * (500.0 + 37.0 * c) * tt)
            sig += 0.03 * np.exp(
                1j * (2 * np.pi * (-FS / 2 + FS / k * c) * tt + 0.3 * msg))
        rf = ComplexArray(jnp.asarray(sig.real, jnp.float32),
                          jnp.asarray(sig.imag, jnp.float32))
        st_x, st_p = m.init(), mp.init()
        # block 0 skips the zero-primed warmup region: the first filtered
        # samples are near-zero and their atan2 phase is branch-cut
        # ill-posed between two correct implementations
        for blk, skip in ((0, 256), (1, 0)):
            part = rf[..., blk * n:(blk + 1) * n]
            st_x, y_x = m.step(st_x, part)
            st_p, y_p = mp.step(st_p, part)
            y_x, y_p = np.asarray(y_x), np.asarray(y_p)
            scale = np.max(np.abs(y_x))
            assert np.max(
                np.abs(y_x[:, skip:] - y_p[:, skip:])) / scale < 1e-4, blk
        np.testing.assert_allclose(st_p[2].to_numpy(), st_x[2].to_numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(st_p[3]), np.asarray(st_x[3]),
                                   atol=1e-6)

    @pytest.mark.parametrize("impl", ["pallas", "pfb_pallas"])
    def test_removed_impl_raises(self, impl):
        """No kernel serves the PFB: a kernel impl is an error."""
        taps = _lowpass(64, 0.4 / 16)
        with pytest.raises(ValueError, match="unknown impl"):
            pfb_channelize(_planar(16 * 64), taps, 16, impl=impl)

    def test_under_filled_grid_lifts_to_decimation(self):
        """8 channels on even bins of an Fs/64 grid: the minimal K=32 is
        lifted to a multiple of D=64."""
        from gsdr_tpu.ops.pfb import uniform_grid

        even = [2 * i * 1e6 / 64 for i in range(8)]
        got = uniform_grid(even, 1e6, multiple_of=64)
        assert got is not None and got[0] == 64 and got[1][1] == 2

    def test_uniform_grid_multiple_of(self):
        from gsdr_tpu.ops.pfb import uniform_grid

        k, bins = uniform_grid([2 * FS / 64], FS, multiple_of=64)
        assert k == 64 and bins == [2]
        # lifting past max_k -> rejected
        assert uniform_grid([FS / 64], FS, max_k=100, multiple_of=3000) \
            is None

    def test_non_grid_config_rejected(self):
        import dataclasses as dc

        from gsdr_tpu.pipelines import FmChannelizer

        m = FmChannelizer(
            sample_rate=1e6, tuning_frequency=0.0,
            channel_frequencies=(100_000.0, 161_234.567),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=tuple(_lowpass(64, 0.03).tolist()), impl="pfb")
        rf = _planar(4096)
        with pytest.raises(ValueError, match="Fs/K grid"):
            m.step(m.init(), rf)


class TestPfbSynthesis:
    """Round-4 synthesis (transmit) bank — the inverse of pfb_channelize."""

    def test_dc_channel_becomes_grid_tone(self):
        from gsdr_tpu.ops.pfb import pfb_synthesize

        k, q = 16, 8
        taps = _lowpass(k * q, 0.4 / k)
        m = 512
        for c_target in (0, 3, 11):
            y = ComplexArray(np.zeros((k, m), np.float32),
                             np.zeros((k, m), np.float32))
            re = y.re.copy()
            re[c_target] = 1.0
            y = ComplexArray(jnp.asarray(re), jnp.asarray(y.im))
            x = pfb_synthesize(y, taps, k)
            assert x.shape == (m * k,)
            z = np.asarray(x.re) + 1j * np.asarray(x.im)
            spec = np.abs(np.fft.fft(z[k * q:]))   # skip filter warmup
            peak = np.argmax(spec) / len(spec)     # cycles/sample
            assert abs(peak - c_target / k) < 1.0 / len(spec) * 2, \
                (c_target, peak)

    def test_synthesis_analysis_round_trip_tone(self):
        """A tone in channel c survives synth -> analysis back into
        channel c (matched near-PR prototypes; power check, not sample
        identity — the cascade has group delay and passband shaping)."""
        from gsdr_tpu.ops.pfb import pfb_channelize, pfb_synthesize

        k, q = 16, 8
        taps = _lowpass(k * q, 0.4 / k)
        m = 1024
        c_target = 5
        j = np.arange(m)
        tone = np.exp(2j * np.pi * 0.01 * j)       # well inside the band
        y = ComplexArray(
            jnp.asarray(np.where(np.arange(k)[:, None] == c_target,
                                 tone.real, 0.0), jnp.float32),
            jnp.asarray(np.where(np.arange(k)[:, None] == c_target,
                                 tone.imag, 0.0), jnp.float32))
        x = pfb_synthesize(y, taps, k)
        back = pfb_channelize(x, taps, k)
        power = np.mean(np.abs(back.to_numpy()[:, 2 * q:]) ** 2, axis=-1)
        assert np.argmax(power) == c_target
        others = np.delete(power, c_target)
        assert power[c_target] > 50 * np.max(others)

    def test_oversampled_synthesis_matches_brute_force(self):
        """Round-5 hop < K: x[n] = D * sum_j h[n - jD] * IDFT(y[:,j])[n
        mod K], checked against a direct evaluation at D=K/2 (P=2),
        including a ragged frame count (M % P != 0)."""
        from gsdr_tpu.ops.pfb import pfb_synthesize

        rng = np.random.default_rng(3)
        k, m, d = 8, 37, 4
        taps = _lowpass(4 * k, 0.5 / k)
        y = (rng.standard_normal((k, m))
             + 1j * rng.standard_normal((k, m)))
        yc = ComplexArray(np.asarray(y.real, np.float32),
                          np.asarray(y.imag, np.float32))
        got = pfb_synthesize(yc, taps, k, hop=d).to_numpy()
        t_len = len(taps)
        n_out = m * d
        ref = np.zeros(n_out, complex)
        for n in range(n_out):
            for j in range(m):
                t = n - j * d
                if 0 <= t < t_len:
                    u = np.sum(y[:, j] * np.exp(
                        2j * np.pi * np.arange(k) * n / k))
                    ref[n] += d * taps[t] * u
        assert got.shape == (n_out,)
        err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
        assert err < 1e-5, err

    def test_oversampled_synthesis_reduces_to_critical_at_p1(self):
        """The HOP implementation evaluated at D=K (P=1) must reproduce
        the critical path's output — calling _pfb_synthesize_hop
        directly, because pfb_synthesize(hop=K) dispatches to the
        critical code and comparing that would be f(x)==f(x)
        (round-5 review)."""
        from gsdr_tpu.ops.pfb import _pfb_synthesize_hop, pfb_synthesize

        rng = np.random.default_rng(4)
        k, m = 16, 64
        taps = _lowpass(8 * k, 0.4 / k)
        y = ComplexArray(
            np.asarray(rng.standard_normal((k, m)), np.float32),
            np.asarray(rng.standard_normal((k, m)), np.float32))
        a = pfb_synthesize(y, taps, k).to_numpy()
        b = _pfb_synthesize_hop(y, taps, k, k).to_numpy()
        np.testing.assert_allclose(b, a, atol=2e-5 * np.max(np.abs(a)))

    def test_synthesize_block_invalid_hop_raises(self):
        from gsdr_tpu.ops.pfb import pfb_synthesize_block

        y = ComplexArray.zeros((8, 16))
        taps = _lowpass(32, 0.05)
        for bad in (16, 0, -4, 3):
            with pytest.raises(ValueError, match="divisor"):
                pfb_synthesize_block(y, taps, 8, hop=bad)

    def test_oversampled_duplex_transports_bandlimited_baseband(self):
        """2x-oversampled synthesis against the 2x-oversampled analysis
        (mix_fir_decimate_bank_uniform at D = K/2): basebands bandlimited
        to the channel width round-trip at ~1% EVM — the near-perfect-
        reconstruction regime the critical cascade structurally cannot
        reach (critical EVM ~0.17-0.26 on wideband content). The analysis output carries the e^{2i pi c jD/K} rotor
        ramp (the models' rotate_bank step), removed here directly."""
        from gsdr_tpu.ops.pfb import (
            mix_fir_decimate_bank_uniform,
            pfb_synthesize,
        )

        rng = np.random.default_rng(5)
        k, m = 16, 384
        d = k // 2
        taps = _lowpass(12 * k, 0.55 / k)
        mm_ = np.arange(m)
        bb = np.zeros((k, m), complex)
        for c in range(k):
            for i, f in enumerate((0.03, -0.07, 0.11)):
                bb[c] += 0.5 * np.exp(
                    2j * np.pi * (f * (c + 2 + i) % 0.12) * mm_
                    + 1j * rng.uniform(0, 6))
        yc = ComplexArray(np.asarray(bb.real, np.float32),
                          np.asarray(bb.imag, np.float32))
        wide = pfb_synthesize(yc, taps, k, hop=d)
        out = mix_fir_decimate_bank_uniform(
            wide, taps, [(-c) % k for c in range(k)], k, d).to_numpy()
        span = min(out.shape[1], m) - 8
        for c in range(k):
            ramp = np.exp(-2j * np.pi * c * d * np.arange(span) / k)
            z = out[c, :span] * ramp
            ref = bb[c, :span]
            # z ~ g*ref => g = <ref, z>/<ref, ref> (vdot conjugates its
            # first arg; an extra conjugate would double channel phase)
            g = np.vdot(ref, z) / np.vdot(ref, ref)
            evm = np.sqrt(np.mean(np.abs(z / g - ref) ** 2)
                          / np.mean(np.abs(ref) ** 2))
            assert evm < 0.03, (c, evm)

    def test_streaming_block_split_exact(self):
        """pfb_synthesize_block / pfb_channelize_block: two blocks with a
        carried tail reproduce the single-shot output exactly."""
        from gsdr_tpu.ops.pfb import (
            pfb_channelize,
            pfb_channelize_block,
            pfb_synthesize,
            pfb_synthesize_block,
        )

        k, q = 16, 8
        taps = _lowpass(k * q, 0.4 / k)
        rng = np.random.default_rng(9)
        m = 256
        y = ComplexArray(
            jnp.asarray(rng.standard_normal((k, m)), jnp.float32),
            jnp.asarray(rng.standard_normal((k, m)), jnp.float32))
        # single shot via the block API from zero state
        want, _ = pfb_synthesize_block(y, taps, k)
        o1, tail = pfb_synthesize_block(y[..., :m // 2], taps, k)
        o2, _ = pfb_synthesize_block(y[..., m // 2:], taps, k, tail=tail)
        got = np.concatenate([np.asarray(o1.re), np.asarray(o2.re)])
        np.testing.assert_array_equal(got, np.asarray(want.re))

        n = k * 200
        x = _planar(n)
        wantc, _ = pfb_channelize_block(x, taps, k)
        c1, ctail = pfb_channelize_block(x[..., :n // 2], taps, k)
        c2, _ = pfb_channelize_block(x[..., n // 2:], taps, k, tail=ctail)
        gotc = np.concatenate([np.asarray(c1.re), np.asarray(c2.re)],
                              axis=-1)
        np.testing.assert_array_equal(gotc, np.asarray(wantc.re))

    def test_oversampled_synthesis_block_split_exact(self):
        """hop < K streaming: block-split synthesis with the P-aligned
        carried tail equals the one-shot output exactly (round 5)."""
        from gsdr_tpu.ops.pfb import pfb_synthesize, pfb_synthesize_block

        rng = np.random.default_rng(6)
        k, m, d = 16, 192, 8
        taps = _lowpass(12 * k, 0.55 / k)
        y = ComplexArray(
            np.asarray(rng.standard_normal((k, m)), np.float32),
            np.asarray(rng.standard_normal((k, m)), np.float32))
        want = pfb_synthesize(y, taps, k, hop=d).to_numpy()
        outs, tail = [], None
        for lo, hi in ((0, 64), (64, 96), (96, 192)):
            o, tail = pfb_synthesize_block(y[..., lo:hi], taps, k,
                                           tail=tail, hop=d)
            outs.append(o.to_numpy())
        got = np.concatenate(outs)
        np.testing.assert_array_equal(got, want)
        # a non-P-multiple block must refuse (phase alignment)
        with pytest.raises(ValueError, match="multiple of"):
            pfb_synthesize_block(y[..., :33], taps, k, hop=d)

    def test_streaming_block_must_be_k_multiple(self):
        """A block whose length is not a K-multiple would silently restart
        frame alignment for every later block (the carried tail is always
        a K-multiple) — must raise, not corrupt (advisor, round 4)."""
        from gsdr_tpu.ops.pfb import pfb_channelize_block

        k, q = 8, 4
        taps = _lowpass(k * q, 0.4 / k)
        x = _planar(k * 50 + 3)  # not a multiple of K
        with pytest.raises(ValueError, match="multiple of"):
            pfb_channelize_block(x, taps, k)

    def test_streaming_short_blocks_exact(self):
        """Blocks SHORTER than the carried tail must still compose exactly
        (the tail comes from the concatenated stream — code-review
        round 4: a short block used to silently truncate the tail)."""
        from gsdr_tpu.ops.pfb import (
            pfb_channelize_block,
            pfb_synthesize_block,
        )

        k, q = 16, 8
        taps = _lowpass(k * q, 0.4 / k)
        rng = np.random.default_rng(11)
        m = 64
        y = ComplexArray(
            jnp.asarray(rng.standard_normal((k, m)), jnp.float32),
            jnp.asarray(rng.standard_normal((k, m)), jnp.float32))
        want, _ = pfb_synthesize_block(y, taps, k)
        got, tail = [], None
        for lo, hi in ((0, 3), (3, 5), (5, 40), (40, m)):  # 3,2,35,24 cols
            o, tail = pfb_synthesize_block(y[..., lo:hi], taps, k,
                                           tail=tail)
            got.append(np.asarray(o.re))
        # allclose, not equal: different conv lengths vectorize with
        # different reduction associations (~1 ulp)
        np.testing.assert_allclose(np.concatenate(got),
                                   np.asarray(want.re),
                                   rtol=1e-6, atol=1e-6)

        n = k * 64
        x = _planar(n)
        wantc, _ = pfb_channelize_block(x, taps, k)
        gotc, ctail = [], None
        for lo, hi in ((0, k * 2), (k * 2, k * 3), (k * 3, n)):
            o, ctail = pfb_channelize_block(x[..., lo:hi], taps, k,
                                            tail=ctail)
            gotc.append(np.asarray(o.re))
        np.testing.assert_allclose(np.concatenate(gotc, axis=-1),
                                   np.asarray(wantc.re),
                                   rtol=1e-6, atol=1e-6)

    def test_batch_axis(self):
        from gsdr_tpu.ops.pfb import pfb_synthesize

        k, q = 8, 4
        taps = _lowpass(k * q, 0.4 / k)
        rng = np.random.default_rng(3)
        y = ComplexArray(
            jnp.asarray(rng.standard_normal((2, k, 64)), jnp.float32),
            jnp.asarray(rng.standard_normal((2, k, 64)), jnp.float32))
        out = pfb_synthesize(y, taps, k)
        assert out.shape == (2, 64 * k)
        one = pfb_synthesize(y[1], taps, k)
        np.testing.assert_allclose(out[1].to_numpy(), one.to_numpy(),
                                   atol=1e-6)


def test_batch_axis():
    k, q = 8, 4
    taps = _lowpass(k * q, 0.4 / k)
    x = _planar(2 * 1024).reshape(2, 1024)
    out = pfb_channelize(x, taps, k)
    assert out.shape == (2, k, 1024 // k - q + 1)
    one = pfb_channelize(x[1], taps, k)
    np.testing.assert_allclose(out[1].to_numpy(), one.to_numpy(), atol=1e-6)
