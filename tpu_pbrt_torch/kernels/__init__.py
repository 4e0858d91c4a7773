"""Hand-written Hopper kernels of the stream tracer, with their plain versions.

- kernels/flush.py::flush_chunk — csrc/flush.cu, the leaf-block triangle
  tests + closest-hit merge (replaces fusedwave.fused_flush_chunk);
- kernels/expand.py::expand — csrc/expand.cu, the 8-child slab tests and
  push keys of a popped stack slab (replaces fusedwave.fused_expand).

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain PyTorch version beside it. LAUNCHES counts the
kernel launches of each wrapper, so a run can show that its traversal
went through the kernels.

Each wrapper call also runs inside `kernel_call`, the seam through which
an op recorder (analysis/record.py) sees it: the kernels are bound
through ctypes, so no dispatch mode sees a launch, and a plain version's
own torch ops are not the kernel's. With no observer installed the seam
costs one test per call.
"""

from __future__ import annotations

import contextlib

#: wrapper name -> number of CUDA launches since the last reset
LAUNCHES = {"flush_chunk": 0, "expand": 0}

#: the observer of the wrappers' calls, or None: it has
#: `kernel_call(name, args)`, a context manager around the call
#: (analysis/record.py OpRecorder)
OBSERVER = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_call(name: str, args: tuple):
    """Around one wrapper call: the installed observer sees it as one op
    named `name` with the call's arguments."""
    if OBSERVER is None:
        return contextlib.nullcontext()
    return OBSERVER.kernel_call(name, args)
