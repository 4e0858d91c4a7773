"""Reconstruction filters (port of tpu_pbrt/core/filters.py: the box filter).

A filter is a (name, radius_x, radius_y, params) spec evaluated exactly
inside the film deposit. Only "box" is ported; any other filter name
raises instead of being substituted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pbrt_torch.utils.error import PbrtError


class FilterSpec(NamedTuple):
    name: str
    xwidth: float
    ywidth: float
    p0: float
    p1: float

    def evaluate(self, dx, dy):
        """Filter value at offset (dx, dy) from the filter center; batched."""
        inside = (torch.abs(dx) <= self.xwidth) & (torch.abs(dy) <= self.ywidth)
        return torch.where(inside, torch.ones_like(dx), torch.zeros_like(dx))


def make_filter(name: str, params) -> FilterSpec:
    """api.cpp MakeFilter, restricted to the ported box filter."""
    if name == "box":
        return FilterSpec(
            "box",
            params.find_one_float("xwidth", 0.5),
            params.find_one_float("ywidth", 0.5),
            0.0,
            0.0,
        )
    raise PbrtError(
        f'PixelFilter "{name}" is not ported to tpu_pbrt_torch yet (ported: "box")'
    )
