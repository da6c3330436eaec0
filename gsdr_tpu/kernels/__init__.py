"""Hand-written GPU kernels: Pallas lowered through Triton.

A kernel stays here only while it beats the XLA path it replaces, end to
end, on the GPU (PERF.md). Off a GPU a kernel runs only in the Pallas
interpreter, and only when the caller passes ``interpret=True``
(gsdr_tpu.backend.use_kernel).
"""

from gsdr_tpu.kernels.fm_chain_triton import fm_chain, fm_chain_supported

__all__ = ["fm_chain", "fm_chain_supported"]
