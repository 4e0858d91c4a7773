"""Closest-hit record shared by every intersector of the port.

Counterpart of tpu_pbrt/accel/traverse.py::Hit (the binary-BVH walker of
that module is not ported: the port traces through the stream tracer,
accel/stream.py, or the brute feature product, accel/mxu.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32, inf on miss
    prim: torch.Tensor  # (R,) i32 leaf-order triangle id, -1 on miss
    b0: torch.Tensor  # (R,) barycentric weight of v0
    b1: torch.Tensor  # (R,) barycentric weight of v1
    tv: Optional[torch.Tensor] = None  # (R, 3, 3) hit triangle's vertices
