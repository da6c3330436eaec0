"""Smoke run of the FM channelizer on the GPU: the main path, end to end.

    python chip_smoke.py               # one GPU: phases a-e below
    python chip_smoke.py --four-cards  # four GPUs: the sharded step only
    python chip_smoke.py --rehearse    # CPU, tiny sizes, kernels in the
                                       # Pallas interpreter; ends "ok": false

The model is the flagship of __graft_entry__.py: FmChannelizer with 16
channels, 64 taps and D=4, fed 2^20 complex samples per step.

  (a) the card's name and power limit (nvidia-smi) and jax.devices();
  (b) jax.jit(model.step) compiled at full width, memory_analysis();
  (c) 4 streaming steps with the state carried, on real FM carriers: the
      served path against the float32 XLA chain (max|d|/max|ref| <= 4.2e-5)
      and the XLA chain against a float64 numpy/scipy reference of the same
      chain on the first 2^16 samples (<= 1e-4), both past the first 256
      outputs (warmup and de-emphasis settle);
  (d) every hand-written kernel against the XLA path at the same shapes,
      alternating, each timed window ended by jax.block_until_ready;
  (e) the served path: a generated int8 IQ file through
      gsdr_tpu.tools.fm_rx (StreamRunner), checked against model.step;
  (f) the tests marked ``gpu`` (pytest -m gpu), in this process.

With --four-cards: a make_mesh(channel=2, time=2) mesh over four GPUs runs
make_sharded_fm_step for 3 steps at N = 2^20, and the same blocks go
through the one-device step on device 0; the two must agree.

Every phase raises on failure; the last line of standard output is one
JSON object, {"ok": true, "device": {...}} only after a full GPU run.
Without a GPU the script runs no phase and exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SERVED_VS_XLA = 4.2e-5
XLA_VS_F64 = 1e-4
SHARDED_VS_ONE = 2e-4    # the sharded-vs-single bar of tests/test_parallel.py
SETTLE = 256             # outputs skipped: warmup and de-emphasis settle


def _say(*args):
    print(*args, flush=True)


def _rel(got, ref, skip=0):
    got = np.asarray(got)[:, skip:]
    ref = np.asarray(ref)[:, skip:]
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _check(name, err, bar):
    _say(f"  {name}: max|d|/max|ref| = {err!r} (bar {bar})")
    if not np.isfinite(err) or err > bar:
        raise AssertionError(f"{name}: {err!r} exceeds {bar}")


def _card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _f64_reference(model, x, n_out):
    """The same chain in float64 numpy/scipy: per-channel mix with exact
    phases, FIR + decimate, discriminator (a zero product, from the zero
    carry of a cold start, demodulates to 0), de-emphasis (lfilter)."""
    from scipy.signal import lfilter

    t = model.num_taps
    d = model.decimation
    fs = float(model.sample_rate)
    h = np.asarray(model.low_pass_taps, np.float64)
    xb = np.concatenate([np.zeros(t - 1), x])
    idx = np.arange(len(xb)) - (t - 1)
    b, a = model._deemph()
    out = []
    for shift in model._shifts():
        lo = np.exp(2j * np.pi * np.mod(shift * idx, fs) / fs)
        filt = np.convolve(xb * lo, h[::-1], mode="valid")[::d][:n_out]
        q = filt * np.conj(np.concatenate([[0.0], filt[:-1]]))
        dem = np.where(q == 0, 0.0, model.gain * np.angle(q))
        out.append(lfilter(b, a, dem))
    return np.asarray(out)


def _time_pair(fns, args, reps, iters):
    """Alternating timed windows of each fn (same args, same process);
    each window ends in block_until_ready. Returns median ms per call."""
    import jax

    times = {k: [] for k in fns}
    for fn in fns.values():            # compile for these args, warm up
        jax.block_until_ready(fn(*args))
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            jax.block_until_ready(out)
            times[k].append((time.perf_counter() - t0) / iters * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def one_card(sz, rehearse):
    import dataclasses

    import jax

    from __graft_entry__ import _model, fm_test_signal
    from gsdr_tpu.carray import ComplexArray

    model = _model(num_channels=16, num_taps=64, decimation=4)
    if rehearse:
        model = dataclasses.replace(model, impl="pallas", interpret=True)
    model_xla = dataclasses.replace(model, impl="xla", interpret=False)
    n = sz["n"]
    _say(f"model: C={model.num_channels} T={model.num_taps} "
         f"D={model.decimation} N={n}; served path "
         f"{'fused kernel' if model.uses_kernel() else 'XLA'}")

    # (b) compile at full width
    _say("(b) compile")
    rf0 = fm_test_signal(model, n)
    step = jax.jit(model.step)
    t0 = time.perf_counter()
    compiled = step.lower(model.init(), rf0).compile()
    _say(f"  compile {time.perf_counter() - t0:.1f} s")
    _say(f"  memory_analysis: {compiled.memory_analysis()}")
    step_xla = jax.jit(model_xla.step)

    # (c) carried steps, served path against XLA, XLA against float64
    _say(f"(c) {sz['steps']} carried steps")
    st, st_x = model.init(), model_xla.init()
    worst = 0.0
    for k in range(sz["steps"]):
        rf = fm_test_signal(model, n, start=k * n)
        st, y = step(st, rf)
        st_x, y_x = step_xla(st_x, rf)
        y, y_x = np.asarray(y), np.asarray(y_x)
        if y.shape != (model.num_channels, n // model.decimation) \
                or not np.all(np.isfinite(y)):
            raise AssertionError(f"step {k}: bad audio {y.shape}")
        worst = max(worst, _rel(y, y_x, SETTLE if k == 0 else 0))
    _check("served vs float32 XLA, all steps", worst, SERVED_VS_XLA)
    n64 = sz["n64"]
    x64 = fm_test_signal(model, n64)
    _, y_x = jax.jit(model_xla.step)(model_xla.init(), x64)
    ref = _f64_reference(model, x64.to_numpy().astype(np.complex128),
                         n64 // model.decimation)
    _check(f"XLA vs float64 reference, first {n64} samples",
           _rel(y_x, ref, SETTLE), XLA_VS_F64)

    # (d) each hand-written kernel against XLA, alternating
    _say("(d) kernel vs XLA, alternating timed windows")
    state = model.init()
    step(state, rf0)
    step_xla(state, rf0)
    ms = _time_pair({"kernel": step, "xla": step_xla}, (state, rf0),
                    sz["reps"], sz["iters"])
    _say(f"  fused FM chain kernel: {ms['kernel']!r} ms/step; "
         f"XLA chain: {ms['xla']!r} ms/step; "
         f"kernel/XLA = {ms['kernel'] / ms['xla']!r} (N={n}, "
         f"{'interpreter' if rehearse else 'GPU'})")

    # (e) the served path: an int8 IQ file through fm_rx / StreamRunner
    _say("(e) fm_rx on a generated int8 IQ file")
    from gsdr_tpu.runtime.host import int8_iq_to_planar, native_available
    from gsdr_tpu.tools import fm_rx

    blocks, blk = sz["rx_blocks"], sz["rx_block"]
    x = fm_test_signal(model, blocks * blk).to_numpy()
    iq = np.empty(2 * x.size, np.int8)
    iq[0::2] = np.clip(np.round(x.real * 127), -127, 127)
    iq[1::2] = np.clip(np.round(x.imag * 127), -127, 127)
    chans = ",".join(repr(f) for f in model.channel_frequencies)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        src, dst = os.path.join(tmp, "in.iq"), os.path.join(tmp, "out.f32")
        iq.tofile(src)
        argv = [src, "-o", dst, "--fs", repr(model.sample_rate),
                "--tuning", repr(model.tuning_frequency), "--channels", chans,
                "--deviation", repr(model.frequency_deviation),
                "--decim", str(model.decimation),
                "--taps", str(model.num_taps), "--cutoff", "0.03",
                "--format", "int8", "--block", str(blk)]
        fm_rx.main(argv)
        audio = np.fromfile(dst, np.float32).reshape(-1, model.num_channels).T
    want = (model.num_channels, blocks * blk // model.decimation)
    if audio.shape != want or not np.all(np.isfinite(audio)):
        raise AssertionError(f"fm_rx wrote {audio.shape}, want {want}")
    re, im = int8_iq_to_planar(iq)
    rf = ComplexArray(jax.numpy.asarray(re), jax.numpy.asarray(im))
    _, y_ref = jax.jit(model_xla.step)(model_xla.init(), rf)
    _check(f"fm_rx ({blocks} blocks of {blk}) vs one XLA step",
           _rel(audio, y_ref, SETTLE), SERVED_VS_XLA)
    _say(f"  host staging: {'native library' if native_available() else 'numpy'}")

    if not rehearse:
        _say("(f) gpu-marked tests")
        import pytest

        os.environ["GSDR_TESTS_ON_GPU"] = "1"   # conftest keeps the GPU
        here = os.path.dirname(os.path.abspath(__file__))
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(here, "tests")])
        if rc != 0:
            raise AssertionError(f"gpu-marked tests: pytest exit code {rc}")


def four_cards(sz, rehearse):
    import dataclasses

    import jax

    from jax.sharding import NamedSharding, PartitionSpec as P

    from __graft_entry__ import _model, fm_test_signal
    from gsdr_tpu.parallel import make_mesh, make_sharded_fm_step

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {len(devs)}")
    model = _model(num_channels=16, num_taps=64, decimation=4)
    if rehearse:
        model = dataclasses.replace(model, impl="pallas", interpret=True)
    mesh = make_mesh(channel=2, time=2, devices=devs[:4])
    sharded = jax.jit(make_sharded_fm_step(model, mesh))
    single = jax.jit(model.step)      # runs where its inputs are: device 0
    n = sz["n"]
    _say(f"sharded FM step on a 2x2 mesh of {devs[0].device_kind}; "
         f"N={n}; per-shard path "
         f"{'fused kernel' if model.uses_kernel() else 'XLA'}")
    st_s, st_1 = model.init(), jax.device_put(model.init(), devs[0])
    worst = 0.0
    for k in range(3):
        rf = fm_test_signal(model, n, start=k * n)
        st_s, y_s = sharded(st_s, rf)
        st_1, y_1 = single(st_1, jax.device_put(rf, devs[0]))
        worst = max(worst, _rel(y_s, y_1, SETTLE if k == 0 else 0))
    _check("sharded (2x2) vs one device, 3 carried steps", worst,
           SHARDED_VS_ONE)
    # timed with each input already where its step reads it: the block
    # split over 'time' on the mesh, or whole on device 0
    rf_mesh = jax.device_put(rf, NamedSharding(mesh, P("time")))
    ms = _time_pair({"sharded": sharded}, (st_s, rf_mesh), sz["reps"],
                    sz["iters"])
    ms.update(_time_pair({"one": single}, (st_1, jax.device_put(rf, devs[0])),
                         sz["reps"], sz["iters"]))
    ms.update(_time_pair({"unplaced": sharded}, (st_s, rf), sz["reps"],
                         sz["iters"]))
    _say(f"  sharded 2x2: {ms['sharded']!r} ms/step with the block on the "
         f"mesh, {ms['unplaced']!r} ms/step with it on one device; one "
         f"device: {ms['one']!r} ms/step")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded step on a 2x2 mesh of 4 GPUs")
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, tiny sizes, kernels in the Pallas interpreter")
    args = p.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = \
            flags + " --xla_force_host_platform_device_count=4"
    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX found {dev.platform!r}); "
              "no phase runs", file=sys.stderr)
        return 2

    from gsdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.rehearse:
        sz = dict(n=1 << 12, steps=4, n64=1 << 12, reps=2, iters=1,
                  rx_blocks=2, rx_block=1 << 11)
    else:
        sz = dict(n=1 << 20, steps=4, n64=1 << 16, reps=5, iters=20,
                  rx_blocks=4, rx_block=1 << 18)

    _say("(a) devices")
    if not args.rehearse:
        for line in _card_lines():
            _say(f"  card: {line}")
    _say(f"  jax.devices(): {jax.devices()}")
    if args.four_cards:
        four_cards(sz, args.rehearse)
        count = 4
    else:
        one_card(sz, args.rehearse)
        count = len(jax.devices())
    print(json.dumps({"ok": not args.rehearse, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
