"""Profiling helpers: traces + throughput reports.

The reference has no profiling facilities at all (SURVEY.md section 5:
vestigial commented-out printf hooks). Here:

  * ``trace(path)`` — context manager around jax.profiler for TensorBoard
    traces of jitted pipelines;
  * ``throughput_report(step, state, block, ...)`` — samples-per-second
    measurement built on gsdr_tpu.utils.timing, with a structured dict
    result naming the device it ran on.
"""

import contextlib

import jax

from gsdr_tpu.utils.timing import time_step


@contextlib.contextmanager
def trace(log_dir):
    """jax.profiler trace context: view with TensorBoard's profile plugin."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def throughput_report(step, state, block, samples_per_step, iters=10,
                      label=""):
    """Measure a streaming step; returns a structured result dict."""
    sec = time_step(step, state, block, iters=iters)
    dev = jax.devices()[0]
    return {
        "label": label,
        "seconds_per_step": sec,
        "samples_per_second": samples_per_step / sec,
        "msamples_per_second": samples_per_step / sec / 1e6,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "iters": iters,
    }
