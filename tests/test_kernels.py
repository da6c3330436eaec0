"""The fused FM chain kernel (kernels/fm_chain_triton.py) and the one
dispatch rule (gsdr_tpu.backend).

On the CPU the kernel runs in the Pallas interpreter (interpret=True) and
is held to the float32 XLA chain of pipelines/fm_radio.py, which shares its
arithmetic (un-rotated bank, constant-phasor discriminator, exact
de-emphasis), so the two agree to float rounding: 1e-5 of the audio scale
leaves two orders of margin over the ~1e-6 they reach. The tests marked
``gpu`` run the compiled kernel and skip without a card (chip_smoke.py runs
them on the GPU).
"""

import dataclasses as dc

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gsdr_tpu.backend as backend
from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.kernels import fm_chain_triton as fct
from gsdr_tpu.pipelines import FmChannelizer

FS = 1_000_000.0
TOL = 1e-5


def _lowpass(nt, cf):
    n = np.arange(nt) - (nt - 1) / 2.0
    h = np.sinc(2 * cf * n) * np.hamming(nt)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _models(nch=4, decimation=4, nt=64, **kw):
    """(XLA model, interpreted-kernel model) of one chain."""
    m = FmChannelizer(
        sample_rate=FS, tuning_frequency=0.0,
        channel_frequencies=tuple(
            100_000.0 + 61_000.0 * i - 400_000.0 * (i % 2)
            for i in range(nch)),
        frequency_deviation=75_000.0, decimation=decimation,
        low_pass_taps=_lowpass(nt, min(0.04, 0.4 / decimation)),
        impl="xla", **kw)
    return m, dc.replace(m, impl="pallas", interpret=True)


def _fm_rf(model, n, seed=0):
    """Real FM carriers on the model's channels: discriminator phase steps
    stay far from the atan2 +-pi branch cut (white noise puts samples on
    it, where two correct implementations may differ by 2*pi)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / model.sample_rate
    sig = np.zeros(n, np.complex128)
    for k, f in enumerate(model.channel_frequencies):
        msg = np.sin(2 * np.pi * (700.0 + 400.0 * k) * t + r.uniform(0, 6))
        sig += (0.5 / len(model.channel_frequencies)) * np.exp(
            1j * (2 * np.pi * f * t + 0.3 * msg))
    return ComplexArray.from_complex(sig.astype(np.complex64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _stream(m_x, m_k, rf, blocks, first_sample_index=0):
    """Run both models over ``blocks`` equal blocks with carried state;
    return the worst audio error and the two final states."""
    step_x, step_k = jax.jit(m_x.step), jax.jit(m_k.step)
    st_x = m_x.init(first_sample_index)
    st_k = m_k.init(first_sample_index)
    n = rf.shape[-1] // blocks
    worst = 0.0
    for b in range(blocks):
        part = rf[..., b * n:(b + 1) * n]
        st_x, y_x = step_x(st_x, part)
        st_k, y_k = step_k(st_k, part)
        assert y_k.shape == y_x.shape == (m_x.num_channels,
                                          n // m_x.decimation)
        worst = max(worst, _rel(y_k, y_x))
    return worst, st_x, st_k


def _assert_states_close(st_a, st_b, atol=1e-5):
    assert int(st_a[0]) == int(st_b[0])
    for a, b in zip(jax.tree.leaves(st_a[1:]), jax.tree.leaves(st_b[1:])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


class TestFusedFmChain:
    def test_matches_unfused_with_state_continuation(self):
        m_x, m_k = _models()
        rf = _fm_rf(m_x, 8192)
        err, st_x, st_k = _stream(m_x, m_k, rf, 2)
        assert err < TOL, err
        _assert_states_close(st_x, st_k)
        # the state pytrees are interchangeable: continue the kernel's
        # stream with the XLA step
        _, y_cont = m_x.step(st_k, rf[..., :4096])
        _, y_ref = m_x.step(st_x, rf[..., :4096])
        assert _rel(y_cont, y_ref) < TOL

    @pytest.mark.parametrize("nch", [1, 3, 8, 16, 20])
    def test_channel_count_coverage(self, nch):
        """Channel counts around the padding to 16 and 32 columns."""
        m_x, m_k = _models(nch=nch)
        err, _, _ = _stream(m_x, m_k, _fm_rf(m_x, 4096, seed=nch), 1)
        assert err < TOL, err

    @pytest.mark.parametrize("decimation", [1, 2, 4, 8])
    def test_decimation_coverage(self, decimation):
        m_x, m_k = _models(decimation=decimation, nt=32)
        rf = _fm_rf(m_x, 4096, seed=decimation)
        err, st_x, st_k = _stream(m_x, m_k, rf, 2)
        assert err < TOL, (decimation, err)
        _assert_states_close(st_x, st_k)

    @pytest.mark.parametrize("nt", [17, 65, 129])
    def test_odd_tap_count_fused(self, nt):
        """Tap counts off the 16/64 chunk sizes (zero-padded taps)."""
        m_x, m_k = _models(nt=nt)
        rf = _fm_rf(m_x, 8192, seed=nt)
        err, st_x, st_k = _stream(m_x, m_k, rf, 2)
        assert err < TOL, err
        _assert_states_close(st_x, st_k)

    def test_nonzero_first_sample_index(self):
        m_x, m_k = _models(nch=2)
        err, _, _ = _stream(m_x, m_k, _fm_rf(m_x, 4096, seed=3), 2,
                            first_sample_index=123_456)
        assert err < TOL, err

    @pytest.mark.parametrize("n", [1024, 5000, 4096 + 64])
    def test_pad_and_mask_any_block_length(self, n):
        """Block lengths that leave the program grid partly empty: the grid
        starts before output 0 and ends on output M-1."""
        m_x, m_k = _models(nch=3, nt=32)
        rf = _fm_rf(m_x, 2 * n, seed=n)
        err, st_x, st_k = _stream(m_x, m_k, rf, 2)
        assert err < TOL, err
        _assert_states_close(st_x, st_k)

    @pytest.mark.parametrize("block_m,phases", [(16, 2), (16, 5), (32, 16)])
    def test_program_geometry_is_inert(self, block_m, phases):
        """Tile rows and phases per program only re-associate the
        de-emphasis; many small programs exercise the cross-block scan."""
        m_x, _ = _models(nch=3, nt=32)
        rf = _fm_rf(m_x, 4096 + 31, seed=block_m + phases)
        buf = rf
        bank = m_x._tap_bank()
        table = m_x._lo_table()
        b, a = m_x._deemph()
        car = ComplexArray(jnp.full((3, 1), 0.3), jnp.full((3, 1), -0.2))
        zi = jnp.full((3, 1), 0.05, jnp.float32)
        rot0 = jnp.int32(12_345)

        def run(**kw):
            return fct.fm_chain(buf, bank, table, rot0, 4, m_x.gain, b, a,
                                car, zi, interpret=True, **kw)

        ref = run()
        got = run(block_m=block_m, phases=phases)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=2e-6)

    def test_identity_deemphasis_is_the_discriminator(self):
        """b=(1, 0), a=(1, 0): the chain reduces to bank + discriminator,
        which fm_discriminate_bank computes in XLA."""
        from gsdr_tpu.ops.channelize import (
            discriminator_prev,
            fm_discriminate_bank,
            mix_fir_decimate_bank,
        )

        m_x, _ = _models(nch=2, nt=32)
        buf = _fm_rf(m_x, 2048 + 31, seed=9)
        bank, table = m_x._tap_bank(), m_x._lo_table()
        car = ComplexArray(jnp.full((2, 1), 0.1), jnp.full((2, 1), 0.2))
        rot0 = jnp.int32(777)
        audio, y_last, z = fct.fm_chain(
            buf, bank, table, rot0, 4, m_x.gain, (1.0, 0.0), (1.0, 0.0),
            car, jnp.zeros((2, 1)), interpret=True)
        y = mix_fir_decimate_bank(buf, bank, 4)
        want = fm_discriminate_bank(
            y, discriminator_prev(car, table, rot0, 4), table, 4, m_x.gain)
        assert _rel(audio, want) < TOL
        np.testing.assert_allclose(y_last.to_numpy(), y[..., -1:].to_numpy(),
                                   atol=1e-6)
        assert np.all(np.asarray(z) == 0)

    def test_prev_override_matches_carry(self):
        """``prev`` (the sharded step's halo sample) in place of the carry."""
        from gsdr_tpu.ops.channelize import discriminator_prev

        m_x, _ = _models(nch=2, nt=32)
        buf = _fm_rf(m_x, 2048 + 31, seed=4)
        bank, table = m_x._tap_bank(), m_x._lo_table()
        b, a = m_x._deemph()
        car = ComplexArray(jnp.full((2, 1), 0.4), jnp.full((2, 1), 0.1))
        rot0 = jnp.int32(99)
        zi = jnp.zeros((2, 1))
        one = fct.fm_chain(buf, bank, table, rot0, 4, m_x.gain, b, a, car,
                           zi, interpret=True)
        two = fct.fm_chain(buf, bank, table, rot0, 4, m_x.gain, b, a,
                           ComplexArray.zeros((2, 1)), zi,
                           prev=discriminator_prev(car, table, rot0, 4),
                           interpret=True)
        for x, y in zip(jax.tree.leaves(one), jax.tree.leaves(two)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    @pytest.mark.parametrize("seed", range(6))
    def test_random_config_parity(self, seed):
        """Seeded random (C, T, D, N) against the XLA chain, two carried
        blocks: the shape-dependent padding and grid interplay."""
        r = np.random.default_rng(100 + seed)
        d = int(r.choice([1, 2, 4, 8, 16]))
        t = int(r.integers(8, 131))
        nch = int(r.integers(1, 12))
        n = d * int(r.integers(192, 1200))
        m_x = FmChannelizer(
            sample_rate=FS, tuning_frequency=0.0,
            channel_frequencies=tuple(
                30_000.0 + 41_000.0 * i for i in range(nch)),
            frequency_deviation=75_000.0, decimation=d,
            low_pass_taps=_lowpass(t, min(0.04, 0.35 / d)), impl="xla")
        m_k = dc.replace(m_x, impl="pallas", interpret=True)
        err, st_x, st_k = _stream(m_x, m_k, _fm_rf(m_x, 2 * n, seed=seed), 2)
        assert err < TOL, (seed, d, t, nch, n, err)
        _assert_states_close(st_x, st_k)

    def test_tap_matrices_reproduce_the_bank(self):
        """The kernel's (2*tp, cp) tap matrices contract a window to the
        same outputs as the XLA conv bank."""
        from gsdr_tpu.ops.channelize import mix_fir_decimate_bank

        m_x, _ = _models(nch=3, nt=40)
        bank = m_x._tap_bank()
        cp, kc, tp = fct._geometry(40, 3)
        gre, gim = fct._tap_matrices(bank, cp, tp)
        x = _fm_rf(m_x, 40, seed=2)
        w = jnp.concatenate([jnp.pad(x.re, (0, tp - 40)),
                             jnp.pad(x.im, (0, tp - 40))])
        want = mix_fir_decimate_bank(x, bank, 4)
        np.testing.assert_allclose(np.asarray(w @ gre)[:3],
                                   want.re[:, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(w @ gim)[:3],
                                   want.im[:, 0], atol=1e-6)
        assert np.all(np.asarray(gre)[:, 3:] == 0)

    def test_row_tables_match_the_recurrence(self):
        """Row-start matrix and block-end weights against the first-order
        recurrence run row by row."""
        pole, block_m, phases = 0.9, 8, 3
        lmat, rowpow = fct._row_tables(pole, block_m, phases)
        e = np.random.default_rng(0).standard_normal(block_m)
        z, starts = 0.0, []
        for i in range(block_m):
            starts.append(z)
            z = z * pole ** phases + e[i]
        np.testing.assert_allclose(lmat @ e, starts, atol=1e-6)
        np.testing.assert_allclose(rowpow @ e, z, atol=1e-6)

    @pytest.mark.parametrize("t,c", [(513, 4), (64, 65), (128, 64)])
    def test_unsupported_shapes_rejected(self, t, c):
        assert not fct.fm_chain_supported(t, c)
        bank = np.zeros((2 * c, 2, t), np.float32)
        with pytest.raises(ValueError):
            fct.fm_chain(ComplexArray.zeros((4 * t,)), bank,
                         np.zeros((c, 4), np.float32), jnp.int32(0), 4, 1.0,
                         (1.0, 0.0), (1.0, 0.0), ComplexArray.zeros((c, 1)),
                         jnp.zeros((c, 1)), interpret=True)

    # (T, C, stages, bytes): shared memory the H100 reported for kernels
    # that did not fit (RESOURCE_EXHAUSTED, "requested <bytes>")
    @pytest.mark.parametrize("t,c,stages,nbytes", [
        (96, 32, 3, 270336), (128, 64, 3, 409600), (192, 16, 3, 299008),
        (256, 32, 3, 532480), (512, 64, 3, 1589248), (128, 64, 2, 344064),
        (256, 16, 2, 266240), (128, 64, 1, 278528), (256, 64, 1, 540672)])
    def test_smem_model_matches_the_h100(self, t, c, stages, nbytes):
        assert fct._smem_bytes(t, c, stages) == nbytes

    # shapes that compiled and ran on an H100 (True) or could not (False)
    @pytest.mark.parametrize("t,c,ok", [
        (64, 16, True), (64, 64, True), (128, 32, True), (256, 16, True),
        (128, 64, False), (256, 32, False)])
    def test_supported_means_it_fits(self, t, c, ok):
        assert fct.fm_chain_supported(t, c) is ok

    @pytest.mark.parametrize("t,c,stages", [
        (32, 16, 3), (64, 16, 3), (64, 32, 2), (64, 64, 1), (128, 16, 1)])
    def test_stage_choice_keeps_two_programs_per_sm(self, t, c, stages):
        """At these shapes the rule's pick was within 3.3 % of the fastest
        stage count measured on an H100 (700 W)."""
        assert fct._num_stages(t, c) == stages
        if stages > 1:
            assert fct._smem_bytes(t, c, stages) <= fct._SMEM_PER_BLOCK // 2


class TestDispatchRule:
    """gsdr_tpu.backend.use_kernel: one rule, no silent fallback."""

    @pytest.mark.parametrize("impl", ["pfb_pallas", "mosaic", ""])
    def test_removed_impl_raises(self, impl):
        with pytest.raises(ValueError, match="unknown impl"):
            dc.replace(_models()[0], impl=impl)

    def test_kernel_impl_on_cpu_without_interpret_raises(self):
        m_x, _ = _models()
        m = dc.replace(m_x, impl="pallas")
        with pytest.raises(ValueError, match="interpret"):
            m.uses_kernel()
        with pytest.raises(ValueError, match="interpret"):
            m.step(m.init(), ComplexArray.zeros((1024,)))

    def test_auto_on_cpu_never_picks_a_kernel(self):
        m_x, _ = _models()
        for m in (dc.replace(m_x, impl="auto"),
                  dc.replace(m_x, impl="auto", interpret=True)):
            assert not m.uses_kernel()
        assert not backend.use_kernel("auto", True, interpret=True)

    def test_auto_on_gpu_picks_kernel_when_supported(self, monkeypatch):
        monkeypatch.setattr(backend, "gpu_kernels_available", lambda: True)
        m_x, _ = _models()
        assert dc.replace(m_x, impl="auto").uses_kernel()
        assert dc.replace(m_x, impl="pallas").uses_kernel()
        assert not m_x.uses_kernel()                         # impl='xla'
        wide = dc.replace(m_x, impl="auto",
                          low_pass_taps=_lowpass(513, 0.01))
        assert not wide.uses_kernel()

    def test_unsupported_shape_with_kernel_impl_raises(self, monkeypatch):
        monkeypatch.setattr(backend, "gpu_kernels_available", lambda: True)
        m_x, _ = _models()
        wide = dc.replace(m_x, impl="pallas",
                          low_pass_taps=_lowpass(513, 0.01))
        with pytest.raises(ValueError, match="shape"):
            wide.uses_kernel()

    def test_pfb_never_runs_the_kernel(self, monkeypatch):
        """impl='pfb' is the XLA polyphase front, on any backend."""
        monkeypatch.setattr(backend, "gpu_kernels_available", lambda: True)
        fs, k = 1_024_000.0, 16
        m = FmChannelizer(
            sample_rate=fs, tuning_frequency=0.0,
            channel_frequencies=tuple(-fs / 2 + fs / k * i for i in range(8)),
            frequency_deviation=75_000.0, decimation=4,
            low_pass_taps=_lowpass(64, 0.4 / k), impl="pfb")
        hlo = jax.jit(m.step).lower(
            m.init(), ComplexArray.zeros((4096,))).as_text()
        assert "fm_chain" not in hlo and "triton" not in hlo.lower()


@pytest.mark.gpu
@pytest.mark.parametrize("nch,nt", [(16, 64), (32, 64), (16, 128)])
def test_kernel_compiles_and_matches_xla_on_gpu(gpu, nch, nt):
    """The compiled kernel (TF32x3) against the float32 XLA chain at the
    served-path bar, two carried blocks: the flagship geometry (3 pipeline
    stages), then shapes that take 2 stages and 1."""
    m_x, _ = _models(nch=nch, nt=nt)
    m_k = dc.replace(m_x, impl="auto")
    assert m_k.uses_kernel()
    rf = _fm_rf(m_x, 1 << 17)
    err, st_x, st_k = _stream(m_x, m_k, rf, 2)
    assert err < 4.2e-5, err
    _assert_states_close(st_x, st_k, atol=1e-4)


@pytest.mark.gpu
def test_kernel_impl_needs_no_interpreter_on_gpu(gpu):
    m_x, _ = _models()
    assert dc.replace(m_x, impl="pallas").uses_kernel()
    assert backend.gpu_kernels_available()
