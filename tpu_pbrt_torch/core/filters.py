"""Reconstruction filters (port of tpu_pbrt/core/filters.py).

pbrt-v3's src/filters/ (box, triangle, gaussian, mitchell, sinc): a
filter is a (name, radius_x, radius_y, params) spec evaluated exactly
inside the film deposit, with the reference's defaults. An unknown name
takes box(0.5) with the reference's warning.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_pbrt_torch.utils.error import Warning


def _cube(x):
    return x * (x * x)


def _mitchell_1d(x, b: float, c: float):
    x = torch.abs(2.0 * x)
    x2 = x * x
    x3 = _cube(x)
    near = ((12.0 - 9.0 * b - 6.0 * c) * x3 + (-18.0 + 12.0 * b + 6.0 * c) * x2
            + (6.0 - 2.0 * b)) * (1.0 / 6.0)
    far = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2 + (-12.0 * b - 48.0 * c) * x
           + (8.0 * b + 24.0 * c)) * (1.0 / 6.0)
    return torch.where(x > 1.0, torch.where(x < 2.0, far, torch.zeros_like(far)), near)


def _sinc(v):
    v = torch.abs(v)
    return torch.where(v < 1e-5, torch.ones_like(v), torch.sin(torch.pi * v) / (torch.pi * v))


def _windowed_sinc(x, radius: float, tau: float):
    x = torch.abs(x)
    return torch.where(x > radius, torch.zeros_like(x), _sinc(x) * _sinc(x / tau))


class FilterSpec(NamedTuple):
    name: str
    xwidth: float
    ywidth: float
    p0: float  # gaussian alpha | mitchell B | sinc tau
    p1: float  # mitchell C

    def evaluate(self, dx, dy):
        """Filter value at offset (dx, dy) from the filter center; batched."""
        ax, ay = torch.abs(dx), torch.abs(dy)
        inside = (ax <= self.xwidth) & (ay <= self.ywidth)
        if self.name == "triangle":
            val = (torch.clamp(self.xwidth - ax, min=0.0)
                   * torch.clamp(self.ywidth - ay, min=0.0))
        elif self.name == "gaussian":
            alpha = self.p0

            def g(d, r):
                return torch.clamp(torch.exp(-alpha * d * d) - math.exp(-alpha * r * r), min=0.0)

            val = g(dx, self.xwidth) * g(dy, self.ywidth)
        elif self.name == "mitchell":
            val = (_mitchell_1d(dx / self.xwidth, self.p0, self.p1)
                   * _mitchell_1d(dy / self.ywidth, self.p0, self.p1))
        elif self.name == "sinc":
            val = (_windowed_sinc(dx, self.xwidth, self.p0)
                   * _windowed_sinc(dy, self.ywidth, self.p0))
        else:  # box
            val = torch.ones_like(dx)
        return torch.where(inside, val, torch.zeros_like(val))


def make_filter(name: str, params) -> FilterSpec:
    """api.cpp MakeFilter (the Create*Filter factories and their defaults)."""
    if name == "box":
        return FilterSpec("box", params.find_one_float("xwidth", 0.5),
                          params.find_one_float("ywidth", 0.5), 0.0, 0.0)
    if name == "triangle":
        return FilterSpec("triangle", params.find_one_float("xwidth", 2.0),
                          params.find_one_float("ywidth", 2.0), 0.0, 0.0)
    if name == "gaussian":
        return FilterSpec("gaussian", params.find_one_float("xwidth", 2.0),
                          params.find_one_float("ywidth", 2.0),
                          params.find_one_float("alpha", 2.0), 0.0)
    if name == "mitchell":
        return FilterSpec("mitchell", params.find_one_float("xwidth", 2.0),
                          params.find_one_float("ywidth", 2.0),
                          params.find_one_float("B", 1.0 / 3.0),
                          params.find_one_float("C", 1.0 / 3.0))
    if name in ("sinc", "lanczossinc", "lanczos"):
        return FilterSpec("sinc", params.find_one_float("xwidth", 4.0),
                          params.find_one_float("ywidth", 4.0),
                          params.find_one_float("tau", 3.0), 0.0)
    Warning(f'Filter "{name}" unknown; using box.')
    return FilterSpec("box", 0.5, 0.5, 0.0, 0.0)
