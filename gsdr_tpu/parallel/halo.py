"""Halo exchange along a time-sharded sample axis (use inside shard_map).

The sharded form of the reference's overlap contracts: a FIR output
window straddling a shard boundary needs the neighbor's edge samples —
exactly what a CUDA thread reads past its output window within one buffer
(/root/reference/src/fir.cu:44-46). One lax.ppermute moves every boundary's
halo in a single collective; shards with no neighbor receive zeros (streaming
zero-prime convention) or a caller-supplied fill (the carried stream tail).
"""

import jax
import jax.numpy as jnp
from jax import lax


def _axis_size(axis_name):
    return lax.psum(1, axis_name)


def _tree_ppermute(x, axis_name, perm):
    return jax.tree_util.tree_map(
        lambda leaf: lax.ppermute(leaf, axis_name, perm), x
    )


def left_halo(x, axis_name, halo, fill=None):
    """Prepend each shard's left neighbor's LAST ``halo`` samples (last axis).

    Shard 0 gets ``fill`` (shape (..., halo)) if given, else zeros — ``fill``
    is how a carried streaming tail (gsdr_tpu.stream.FirStream state) enters
    a time-sharded pipeline. Returns (..., halo + N_local).
    """
    n = _axis_size(axis_name)
    tail = jax.tree_util.tree_map(lambda l: l[..., l.shape[-1] - halo:], x)
    perm = [(i, i + 1) for i in range(n - 1)]
    recv = _tree_ppermute(tail, axis_name, perm)  # shard 0 receives zeros
    if fill is not None:
        idx = lax.axis_index(axis_name)
        recv = jax.tree_util.tree_map(
            lambda r, f: jnp.where(idx == 0, f, r), recv, fill
        )
    return jax.tree_util.tree_map(
        lambda r, l: jnp.concatenate([r, l], axis=-1), recv, x
    )


def right_halo(x, axis_name, halo, fill=None):
    """Append each shard's right neighbor's FIRST ``halo`` samples.

    The last shard gets ``fill`` or zeros. Returns (..., N_local + halo).
    """
    n = _axis_size(axis_name)
    head = jax.tree_util.tree_map(lambda l: l[..., :halo], x)
    perm = [(i, i - 1) for i in range(1, n)]
    recv = _tree_ppermute(head, axis_name, perm)  # last shard receives zeros
    if fill is not None:
        idx = lax.axis_index(axis_name)
        recv = jax.tree_util.tree_map(
            lambda r, f: jnp.where(idx == n - 1, f, r), recv, fill
        )
    return jax.tree_util.tree_map(
        lambda l, r: jnp.concatenate([l, r], axis=-1), x, recv
    )


def last_shard_tail(x, axis_name, halo):
    """The global stream's final ``halo`` samples, replicated to all shards.

    Used to produce the next carried streaming tail after a time-sharded
    step: mask every shard but the last, then psum (cheap: halo is T-1).
    """
    n = _axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    return jax.tree_util.tree_map(
        lambda l: lax.psum(
            jnp.where(idx == n - 1, l[..., l.shape[-1] - halo:], 0.0),
            axis_name,
        ),
        x,
    )
