"""Communication-volume audit of the sharded FM step.

Lower the sharded step (fused kernel per shard, and the XLA PFB front) at
2/4/8 time shards and two block lengths, parse every collective op out of
the StableHLO, and assert the per-step communicated element count is
O(halo) — INDEPENDENT of the block length N. A time-sharded streaming DSP
chain owes exactly: one (T-1+D)-sample halo ppermute, one (C_l,)-vector
de-emphasis state all_gather, and O(T+C) psums (stream tail and
discriminator carry). Anything O(N) is a sharding bug. The audit lowers
only, on a virtual 8-device CPU mesh; what the collectives cost on the
GPUs' NVLink is a measurement for the card (ROADMAP).

Usage:
    python -m benchmarks.scaling
Prints one JSON line per measurement.
"""

import json
import os
import re

# Must precede backend init: the CPU client reads the flag at creation.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np

import jax
import jax.numpy as jnp

_COLLECTIVES = (
    "collective_permute",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "reduce_scatter",
)


def _lowpass(num_taps, cutoff_frac):
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2 * cutoff_frac * n) * np.hamming(num_taps)
    return tuple((h / h.sum()).astype(np.float32).tolist())


def _model(nch=16, taps=64, dec=4):
    """The fused kernel per shard, in the interpreter (lowering only)."""
    from gsdr_tpu.pipelines import FmChannelizer

    return FmChannelizer(
        sample_rate=1_000_000.0, tuning_frequency=0.0,
        channel_frequencies=tuple(
            -480_000.0 + (960_000.0 / nch) * i for i in range(nch)),
        frequency_deviation=75_000.0, decimation=dec,
        low_pass_taps=_lowpass(taps, 0.03), impl="pallas", interpret=True)


def _elems(shape_str):
    dims = [int(p) for p in shape_str.split("x")[:-1] if p.isdigit()]
    return int(np.prod(dims)) if dims else 1


def collective_volume(hlo_text):
    """(total result elements, per-op counts) over all collective ops."""
    total = 0
    per_op = {}
    pat = re.compile(r"->\s*tensor<([^>]+)>")
    for line in hlo_text.splitlines():
        op = next((c for c in _COLLECTIVES
                   if f"stablehlo.{c}" in line), None)
        if op is None:
            continue
        m = pat.search(line)
        if not m:
            continue
        elems = _elems(m.group(1))
        total += elems
        per_op[op] = per_op.get(op, 0) + elems
    # all_reduce (psum) carries a reducer REGION, so its result type sits
    # lines after the op name — match it across lines separately
    for m in re.finditer(
            r"stablehlo\.all_reduce.*?\}\)\s*:\s*\([^)]*\)\s*->"
            r"\s*tensor<([^>]+)>", hlo_text, re.S):
        elems = _elems(m.group(1))
        total += elems
        per_op["all_reduce"] = per_op.get("all_reduce", 0) + elems
    return total, per_op


def _grid_model(nch=8, k=16, taps=128, dec=4, impl="pfb"):
    """Uniform-grid config for the PFB sharded path."""
    from gsdr_tpu.pipelines import FmChannelizer

    fs = 1_024_000.0
    return FmChannelizer(
        sample_rate=fs, tuning_frequency=0.0,
        channel_frequencies=tuple(-fs / 2 + (fs / k) * i
                                  for i in range(nch)),
        frequency_deviation=75_000.0, decimation=dec,
        low_pass_taps=_lowpass(taps, 0.4 / k), impl=impl)


def comm_volume_audit():
    """Collective volume must be O(halo), independent of N — for both the
    fused dense and the PFB sharded fronts."""
    from gsdr_tpu.carray import ComplexArray
    from gsdr_tpu.parallel import make_mesh, make_sharded_fm_step

    results = []
    for t_sh in (2, 4, 8):
        for label, model in (
                ("fm", _model(nch=8, taps=64, dec=4)),
                ("fm_pfb", _grid_model())):
            mesh = make_mesh(channel=1, time=t_sh,
                             devices=jax.devices()[:t_sh])
            step = make_sharded_fm_step(model, mesh)
            vols = {}
            for n in (1 << 14, 1 << 16):  # 4x apart: O(N) comm shows 4x
                rng = np.random.default_rng(0)
                rf = ComplexArray(
                    jnp.asarray(rng.standard_normal(n), jnp.float32),
                    jnp.asarray(rng.standard_normal(n), jnp.float32))
                lowered = jax.jit(step).lower(model.init(), rf)
                vols[n], per_op = collective_volume(lowered.as_text())
            n_small, n_big = sorted(vols)
            row = {
                "metric": f"sharded_{label}_collective_elems_per_step",
                "time_shards": t_sh,
                "elems_at_16k": vols[n_small],
                "elems_at_64k": vols[n_big],
                "per_op": per_op,
                "comm_is_o_halo": bool(vols[n_big] == vols[n_small]),
            }
            assert vols[n_big] == vols[n_small], (
                f"collective volume grew with N: {vols} — O(N) comm bug")
            assert vols[n_big] > 0, "no collectives found in lowered HLO"
            results.append(row)
            print(json.dumps(row), flush=True)
    return results


def main():
    # the audit only lowers (never executes), so the virtual CPU mesh is
    # the right backend even where a GPU is attached
    jax.config.update("jax_platforms", "cpu")
    comm_volume_audit()


if __name__ == "__main__":
    main()
