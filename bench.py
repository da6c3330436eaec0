"""Benchmark: flagship FM channelizer step rate on the GPU.

Prints ONE JSON line: the input rate of the path that serves
(FmChannelizer.step with impl='auto': the fused kernel where it runs),
its agreement with the float32 XLA chain, the device and the card's power
limit.

Config (__graft_entry__._model): 16-channel FM broadcast chain — mix bank
-> 64-tap FIR with 4x decimation -> quadrature discriminator -> IIR
de-emphasis — on 2^20 complex input samples per step.

Metric: complex input Msamples/s through the full chain (input-referred,
so comparable across channel counts at fixed work per sample). Each timed
window runs ITERS steps and ends in jax.block_until_ready; the median of
REPS windows is reported. Without a GPU the script exits non-zero.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

import jax

from __graft_entry__ import _model, fm_test_signal
from gsdr_tpu.utils.compile_cache import enable_compile_cache

N_SAMPLES = 1 << 20
ITERS = 20
REPS = 5
SETTLE = 256  # outputs skipped: zero-primed warmup + de-emphasis settle


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform!r})", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]

    model = _model(num_channels=16, num_taps=64, decimation=4)
    model_xla = dataclasses.replace(model, impl="xla")
    rf = fm_test_signal(model, N_SAMPLES)
    step = jax.jit(model.step)
    state = model.init()
    jax.block_until_ready(step(state, rf))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = step(state, rf)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / ITERS)
    sec = float(np.median(times))

    _, y = step(state, rf)
    _, y_x = jax.jit(model_xla.step)(state, rf)
    y, y_x = np.asarray(y)[:, SETTLE:], np.asarray(y_x)[:, SETTLE:]
    err = float(np.max(np.abs(y - y_x)) / np.max(np.abs(y_x)))
    print(json.dumps({
        "metric": "fm_channelizer_16ch_64tap_dec4_input_msps",
        "value": N_SAMPLES / sec / 1e6,
        "unit": "Msamples/s",
        "step_us": sec * 1e6,
        "served_path": "fused kernel" if model.uses_kernel() else "XLA",
        "served_vs_xla_max_rel_err": err,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
