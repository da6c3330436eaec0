"""Multi-host bring-up helpers.

The reference is single-process/single-GPU; this framework's distributed
layer is mesh-shape-agnostic (all collectives go through named axes), so
multi-host operation is strictly a placement concern:

  * call ``initialize()`` once per host process (the jax.distributed
    handshake over the network between hosts);
  * build the mesh with hosts on the OUTER (channel) axis — channel
    sharding is communication-free, so host boundaries never carry the
    per-block ppermute halos, which stay on the NVLink inside a host.

Everything already tested on the virtual CPU mesh (tests/test_parallel.py)
runs unchanged on a real pod slice: shard_map in-specs name mesh axes, not
devices. This module only wires up initialization and the recommended
host-aligned mesh layout.
"""

import numpy as np

import jax
from jax.sharding import Mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize with pass-through arguments. A GPU host
    with no cluster manager discovers none of them: pass
    ``coordinator_address`` ('host:port'), ``num_processes`` and
    ``process_id`` explicitly."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_pod_mesh(channel_per_host=None):
    """('channel', 'time') mesh with host boundaries on the channel axis.

    With H hosts of L local devices each: channel = H * c, time = L / c
    (c = channel_per_host, default 1). Channel sharding crosses hosts
    freely (zero communication); the time axis — which exchanges a halo
    and all-gathers IIR state every block — stays inside each host, on
    NVLink.
    """
    devs = jax.devices()
    procs = jax.process_count()
    local = len(devs) // procs
    c = int(channel_per_host or 1)
    if local % c != 0:
        raise ValueError(f"channel_per_host {c} must divide {local}")
    time = local // c
    # jax.devices() orders by process; reshape host-major so that rows
    # (channel groups) align with hosts.
    arr = np.asarray(devs).reshape(procs * c, time)
    return Mesh(arr, ("channel", "time"))
