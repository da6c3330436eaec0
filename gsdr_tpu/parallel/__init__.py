"""Distributed layer: device meshes, halo exchange, sharded pipelines.

The reference is single-process, single-GPU-per-call — it has no distributed
backend at all (SURVEY.md section 2.3). This layer is the new capability
this framework adds: signals scale over a jax.sharding.Mesh with two axes,

  * ``channel`` — independent streams (the reference's 2x/4x/8x multi-stream
    kernel families become rows of a channel-sharded batch axis);
  * ``time``   — the sample axis, split into contiguous blocks per chip; the
    reference's intra-device overlap contracts (FIR reads T-1 past its
    window, src/fir.cu:44-46; FM's +1 sample warp shuffle, src/fm.cu:58-64)
    become a (T-1+D)-sample halo exchange between time-neighbour devices
    via lax.ppermute (NVLink between the GPUs of one host). Oscillator phase
    needs NO communication: it is computed from global sample indices
    (gsdr_tpu.utils.phase), so any device can mint the exact LO for its
    block.

IIR state is the one true sequential dependency; gsdr_tpu.parallel.iir
propagates it across time shards with an all-gather of per-shard
state-transition effects plus a host-precomputed correction matmul — exact,
log-free, and O(shards * order) bytes on the wire.
"""

from gsdr_tpu.parallel.mesh import make_mesh
from gsdr_tpu.parallel.halo import left_halo, right_halo
from gsdr_tpu.parallel.iir import sharded_iir
from gsdr_tpu.parallel.channelizer import (
    sharded_fir,
    make_sharded_fm_step,
    make_sharded_am_step,
)

__all__ = [
    "make_mesh",
    "left_halo",
    "right_halo",
    "sharded_iir",
    "sharded_fir",
    "make_sharded_fm_step",
    "make_sharded_am_step",
]

from gsdr_tpu.parallel.modem import (  # noqa: E402
    make_sharded_qpsk_modem,
    make_sharded_qpsk256_modem,
)

__all__ += ["make_sharded_qpsk_modem", "make_sharded_qpsk256_modem"]

from gsdr_tpu.parallel.multihost import initialize, make_pod_mesh  # noqa: E402

__all__ += ["initialize", "make_pod_mesh"]
