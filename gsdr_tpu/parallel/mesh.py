"""Mesh construction for the (channel, time) sharding model."""

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(channel=1, time=1, devices=None):
    """Build a Mesh with named axes ('channel', 'time').

    ``channel * time`` must equal the device count. On a multi-host pod
    slice, pass ``devices=jax.devices()`` after jax.distributed.initialize;
    the default uses all local/global devices. The mesh follows the
    algorithm: the GPUs of one host reach each other all to all over
    NVLink, so any (channel, time) split of them costs the same per byte.
    Channel sharding communicates nothing per block; time sharding
    exchanges a (T-1+D)-sample halo and all-gathers the de-emphasis state
    every block. Across hosts, prefer channel sharding (the network is the
    slower link).
    """
    devices = jax.devices() if devices is None else list(devices)
    if channel * time != len(devices):
        raise ValueError(
            f"channel*time = {channel * time} != device count {len(devices)}"
        )
    arr = np.asarray(devices).reshape(channel, time)
    return Mesh(arr, ("channel", "time"))
