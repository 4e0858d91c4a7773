"""Hand-written Hopper kernels of the stream tracer, with their plain versions.

- kernels/flush.py::flush_chunk — csrc/flush.cu, the leaf-block triangle
  tests + closest-hit merge (replaces fusedwave.fused_flush_chunk);
- kernels/expand.py::expand — csrc/expand.cu, the 8-child slab tests and
  push keys of a popped stack slab (replaces fusedwave.fused_expand).

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain PyTorch version beside it. LAUNCHES counts the
kernel launches of each wrapper, so a run can show that its traversal
went through the kernels.
"""

from __future__ import annotations

#: wrapper name -> number of CUDA launches since the last reset
LAUNCHES = {"flush_chunk": 0, "expand": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
