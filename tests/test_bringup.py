"""The GPU bring-up surface: the compile-cache helper, chip_smoke.py's
refusal to run without a GPU, and the discriminator identities the fused
kernel and the XLA chain share."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.ops.channelize import (
    discriminator_carry,
    discriminator_prev,
    fm_discriminate_bank,
    rotate_bank,
)
from gsdr_tpu.ops.quad_demod import quad_fm_demod
from gsdr_tpu.utils import compile_cache
from gsdr_tpu.utils.phase import phase_digit_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1_000_000.0
SHIFTS = [-480_000.0, 123_457.0, 60_000.0]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_leaves_env_dir_alone(monkeypatch, tmp_path,
                                            restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def _smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("GSDR_TESTS_ON_GPU", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "bare_directory"])
def test_chip_smoke_without_gpu_exits_nonzero(where, tmp_path):
    cwd = REPO
    if where == "bare_directory":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = tmp_path
    out = _smoke(cwd)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_rehearsal_ends_not_ok():
    out = _smoke(REPO, "--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and last["device"]["platform"] == "cpu"


def _random_y(c, m, seed):
    r = np.random.default_rng(seed)
    z = r.standard_normal((c, m)) + 1j * r.standard_normal((c, m))
    return ComplexArray.from_complex(z.astype(np.complex64))


def test_carry_round_trips_through_the_next_block():
    """discriminator_carry then discriminator_prev at the next block's
    window 0 recover the last un-rotated output to float rounding."""
    table = phase_digit_table(SHIFTS, FS)
    y_last = _random_y(3, 1, 0)
    rot0_next = jnp.int32(999_937)
    carry = discriminator_carry(y_last, table, rot0_next, 4)
    back = discriminator_prev(carry, table, rot0_next, 4)
    np.testing.assert_allclose(back.to_numpy(), y_last.to_numpy(),
                               atol=1e-6)


def test_constant_phasor_discriminator_equals_rotated_one():
    """fm_discriminate_bank == rotate_bank then quad_fm_demod: equal up to
    the rotor's digit-table rounding, which the constant phasor avoids."""
    table = phase_digit_table(SHIFTS, FS)
    y = _random_y(3, 256, 1)
    rot0 = jnp.int32(4321)
    carry = ComplexArray(jnp.full((3, 1), 0.7), jnp.full((3, 1), -0.4))
    got = fm_discriminate_bank(
        y, discriminator_prev(carry, table, rot0, 4), table, 4, 1.0)
    rot = rotate_bank(y, jnp.asarray(table), rot0, 4)
    want = quad_fm_demod(ComplexArray(
        jnp.concatenate([carry.re, rot.re], -1),
        jnp.concatenate([carry.im, rot.im], -1)), 1.0)
    diff = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(want))))
    assert np.max(np.abs(diff)) < 1e-3


def test_zero_product_demodulates_to_zero():
    """A zero carry (cold start) gives output 0, not the +-pi of signed
    zeros in atan2."""
    table = phase_digit_table(SHIFTS, FS)
    y = _random_y(3, 8, 2)
    zero = ComplexArray.zeros((3, 1))
    out = np.asarray(fm_discriminate_bank(y, zero, table, 4, 2.0))
    assert np.all(out[:, 0] == 0.0)
    assert np.all(out[:, 1:] != 0.0)
