"""Two-process jax.distributed smoke test.

Spawns 2 real OS processes, each with 4 virtual CPU devices, performs the
jax.distributed coordinator handshake, builds the host-aligned
('channel', 'time') pod mesh via gsdr_tpu.parallel.multihost, and runs two
sharded FM-channelizer steps on GLOBAL arrays — the first exercise of the
multi-process path (everything else covers it only with a single-process
virtual mesh). Output is allgathered and compared against the
single-process reference step.
"""

import os
import socket
import subprocess
import sys

import numpy as np

_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.local_devices()) == 4, jax.local_devices()
assert len(jax.devices()) == 8

from jax.sharding import NamedSharding, PartitionSpec as P

from gsdr_tpu.carray import ComplexArray
from gsdr_tpu.parallel import make_sharded_fm_step
from gsdr_tpu.parallel.multihost import make_pod_mesh
from gsdr_tpu.pipelines import FmChannelizer


def lowpass(nt, cf):
    n = np.arange(nt) - (nt - 1) / 2.0
    h = np.sinc(2 * cf * n) * np.hamming(nt)
    return tuple((h / h.sum()).astype(np.float32).tolist())


mesh = make_pod_mesh(channel_per_host=2)
assert dict(mesh.shape) == {"channel": 4, "time": 2}, mesh.shape

model = FmChannelizer(
    sample_rate=1_000_000.0, tuning_frequency=0.0,
    channel_frequencies=tuple(50_000.0 + 60_000.0 * i for i in range(16)),
    frequency_deviation=75_000.0, decimation=4,
    low_pass_taps=lowpass(33, 0.03),
)

N = 2 * 4 * 128  # time_shards * decimation * 128
rng = np.random.default_rng(11)
rf_np = rng.standard_normal((2, N)).astype(np.float32)

sh_time = NamedSharding(mesh, P("time"))
sh_rep = NamedSharding(mesh, P())
sh_chan = NamedSharding(mesh, P("channel", None))


def globalize(np_arr, sh):
    return jax.make_array_from_callback(
        np_arr.shape, sh, lambda idx: np_arr[idx])


def glob_state(state):
    n0, tail, carry, zi = state
    return (
        globalize(np.asarray(n0), sh_rep),
        ComplexArray(globalize(np.asarray(tail.re), sh_rep),
                     globalize(np.asarray(tail.im), sh_rep)),
        ComplexArray(globalize(np.asarray(carry.re), sh_chan),
                     globalize(np.asarray(carry.im), sh_chan)),
        globalize(np.asarray(zi), sh_chan),
    )


step = make_sharded_fm_step(model, mesh)
state = glob_state(model.init())
outs = []
for b in range(2):
    rf = ComplexArray(globalize(rf_np[b], sh_time),
                      globalize(np.zeros_like(rf_np[b]), sh_time))
    state, audio = step(state, rf)
    outs.append(audio)

from jax.experimental import multihost_utils

got = np.concatenate(
    [np.asarray(multihost_utils.process_allgather(a, tiled=True))
     for a in outs], axis=-1)

# single-process reference on the same data
ref_state = model.init()
refs = []
for b in range(2):
    rf = ComplexArray(jnp.asarray(rf_np[b]), jnp.zeros(N, jnp.float32))
    ref_state, audio = model.step(ref_state, rf)
    refs.append(np.asarray(audio))
want = np.concatenate(refs, axis=-1)

scale = np.max(np.abs(want)) + 1e-9
err = np.max(np.abs(got - want)) / scale
assert err < 1e-4, err

# ---- the FUSED per-shard path across a real process boundary ----------
# (impl='pallas' dispatches the fused chain per shard, in the Pallas
# interpreter on the CPU — the halo ppermute / z all_gather / tail psum
# plumbing is what crosses processes here)
import dataclasses

model_f = dataclasses.replace(model, impl="pallas", interpret=True)
step_f = make_sharded_fm_step(model_f, mesh)
state_f = glob_state(model_f.init())
outs_f = []
for b in range(2):
    rf = ComplexArray(globalize(rf_np[b], sh_time),
                      globalize(np.zeros_like(rf_np[b]), sh_time))
    state_f, audio = step_f(state_f, rf)
    outs_f.append(audio)
got_f = np.concatenate(
    [np.asarray(multihost_utils.process_allgather(a, tiled=True))
     for a in outs_f], axis=-1)
ref_state = model_f.init()
refs_f = []
for b in range(2):
    rf = ComplexArray(jnp.asarray(rf_np[b]), jnp.zeros(N, jnp.float32))
    ref_state, audio = model_f.step(ref_state, rf)
    refs_f.append(np.asarray(audio))
want_f = np.concatenate(refs_f, axis=-1)
err_f = np.max(np.abs(got_f - want_f)) / (np.max(np.abs(want_f)) + 1e-9)
assert err_f < 2e-4, err_f

# ---- BASELINE config 5: 256-stream QPSK256 modem sharded across the two
# processes (streams over 'channel' crosses the process boundary) --------
from gsdr_tpu.parallel import make_sharded_qpsk256_modem
from gsdr_tpu.pipelines import Qpsk256Modem
from gsdr_tpu.ops.qpsk256 import CIRCULAR

modem = Qpsk256Modem(constellation_type=CIRCULAR)
tx, rx = make_sharded_qpsk256_modem(modem, mesh)
S, NS = 256, 512
syms_np = rng.integers(0, 256, (S, NS)).astype(np.int32)
sh_sn = NamedSharding(mesh, P("channel", "time"))
syms = globalize(syms_np, sh_sn)
samples = tx(syms)
back = rx(samples)
back_np = np.asarray(multihost_utils.process_allgather(back, tiled=True))
assert np.array_equal(back_np, syms_np), "sharded qpsk256 loopback mismatch"

print(f"MULTIHOST_OK pid={pid} err={err:.2e} fused_err={err_f:.2e} "
      "qpsk256_loopback=exact", flush=True)
"""


def test_two_process_distributed_fm_step(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "child.py"
    script.write_text(_CHILD)

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_PROCESSES", None)
    # the children run on the CPU by design and import the repository
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, out
