"""Timing of streaming steps on the device.

JAX dispatches asynchronously: a call returns before the device finishes.
So each timed window runs ``iters`` chained steps — the state threaded from
one to the next, as a stream would — and ends in jax.block_until_ready;
the median window over ``reps`` gives seconds per step. Compilation and one
warm-up step fall outside the windows.
"""

import time

import jax


def time_step(step, state, block, iters=20, reps=3):
    """Median seconds per ``step(state, block) -> (state, out)``."""
    run = jax.jit(step)
    st, out = run(state, block)          # compile + warm-up
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            st, out = run(st, block)
        jax.block_until_ready((st, out))
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return times[len(times) // 2]
