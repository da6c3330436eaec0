"""The one dispatch rule for the hand-written kernels.

The kernels in gsdr_tpu.kernels are Pallas kernels lowered through Triton.
They compile for a GPU and for nothing else; on any other backend they run
only in the Pallas interpreter, and only when a caller asks for that with
``interpret=True``. No backend test ever turns the interpreter on, and no
kernel request quietly becomes the XLA path.
"""

import jax


def gpu_kernels_available():
    """True when the default backend is a GPU, which compiles the kernels."""
    return jax.default_backend() == "gpu"


def use_kernel(impl, supported, interpret=False, what="kernel"):
    """Decide whether a call runs its hand-written kernel.

    ``impl``: 'pallas' asks for the kernel; 'auto' takes it only on a GPU
    and only when the shape is ``supported``; any other value means the
    XLA path. Asking for the kernel where it cannot run raises ValueError:
    on a backend that cannot compile it (unless ``interpret``), or for a
    shape it does not support.
    """
    if impl == "pallas":
        if not (interpret or gpu_kernels_available()):
            raise ValueError(
                f"impl='pallas': the {what} compiles only for a GPU, and the "
                f"default backend is {jax.default_backend()!r}; pass "
                "interpret=True to run it in the Pallas interpreter")
        if not supported:
            raise ValueError(f"impl='pallas': the {what} does not support "
                             "this shape")
        return True
    return impl == "auto" and supported and gpu_kernels_available()
