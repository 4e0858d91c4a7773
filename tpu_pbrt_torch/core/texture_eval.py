"""Texture evaluation (port of tpu_pbrt/core/texture_eval.py).

pbrt-v3's src/core/texture.{h,cpp} (the 2D/3D mappings, Noise / FBm /
Turbulence), src/core/mipmap.h (the MIP pyramid and its lookups) and the
evaluation of src/textures/* (imagemap, checkerboard, dots, scale, mix,
bilerp, uv, fbm, wrinkled, windy, marble), as the reference realizes
them: the scene compiler hands the non-constant texture nodes to
`build_texture_table`, which packs every imagemap's box-filtered mip
pyramid into one flat (T, 3) float32 atlas (host numpy, bit for bit the
reference's: the sRGB decode, the pyramid and the layout) and compiles
each node tree into an evaluator by recursive composition.

Lookups are bilinear at an explicit level (level 0 without a footprint).
With the (..., 4) [dudx, dvdx, dudy, dvdy] uv footprint of a camera hit,
an imagemap takes the reference's EWA-class filter: the level from the
minor ellipse axis, EWA_TAPS Gaussian-weighted trilinear taps along the
major axis, the eccentricity clamped to MAX_ANISO; a scalar lod takes one
trilinear tap. The noise is the reference's hash-lattice gradient noise
with pbrt's quintic weights and octave sums (its uint32 hash emulated in
int64, masked to 32 bits).

The values are the reference's, operation for operation; what differs is
how much work a wave launches:
- the reference selects a lane's texture as a masked sum over every
  texture of the scene; `evaluate` runs each texture only on the lanes
  whose id names it (one host read for the lane counts, then gather,
  evaluate, scatter back), and only over the ids the calling slot can
  hold;
- the reference's trilinear tap computes a bilinear lookup at EVERY mip
  level and keeps the two it needs; the port gathers each lane's two
  levels through per-lane (offset, width, height) tensors, and looks up
  all EWA taps and both levels in one batched bilinear call;
- the octaves of an FBm sum (and the noise calls of dots) are evaluated
  as one stacked noise call, then summed in the reference's order.
Each is elementwise per lane, so every lane gets the bits of the masked
form (tests/test_torch_textures.py holds them to a literal transcription).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import _M32, _mul32, _u32

#: EWA eccentricity clamp (pbrt ImageTexture maxanisotropy default)
MAX_ANISO = 8.0
#: fixed Gaussian tap count along the major axis
EWA_TAPS = 4


def _i32(x):
    """float -> int32 value as XLA's convert makes it (NaN -> 0, out of
    range saturated), held in int64."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0**32, 2.0**32)
    return x.to(torch.int64).clamp(-(2**31), 2**31 - 1)


def _divc(x, c: float):
    """x / c for a host constant c, as an IEEE division on every device
    (CUDA turns a division by a host scalar into a reciprocal multiply)."""
    return x / torch.full_like(x, float(np.float32(c)))


# -------------------------------------------------------------------------
# noise (texture.cpp Noise/FBm/Turbulence)
# -------------------------------------------------------------------------

def _hash3(xi, yi, zi):
    """The reference's uint32 lattice hash of int coordinates, as int64."""
    h = (_mul32(_u32(xi), 0x9E3779B1) ^ _mul32(_u32(yi), 0x85EBCA77)
         ^ _mul32(_u32(zi), 0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return (h ^ (h >> 12)) & _M32


def _grad(xi, yi, zi, dx, dy, dz):
    """Gradient dot product from one of the 16 Perlin lattice directions
    the hash selects."""
    h = _hash3(xi, yi, zi) & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return (torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v))


def noise3(p):
    """Perlin-style gradient noise in [-1, 1], p: (..., 3)."""
    pi = torch.floor(p)
    d = p - pi
    xi, yi, zi = _i32(pi[..., 0]), _i32(pi[..., 1]), _i32(pi[..., 2])
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    # quintic smoothstep (NoiseWeight in texture.cpp)
    w = d * d * d * (d * (d * 6.0 - 15.0) + 10.0)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def g(ox, oy, oz):
        return _grad(xi + ox, yi + oy, zi + oz, dx - ox, dy - oy, dz - oz)

    def lerp(t, a, b):
        return a + t * (b - a)

    x00 = lerp(wx, g(0, 0, 0), g(1, 0, 0))
    x10 = lerp(wx, g(0, 1, 0), g(1, 1, 0))
    x01 = lerp(wx, g(0, 0, 1), g(1, 0, 1))
    x11 = lerp(wx, g(0, 1, 1), g(1, 1, 1))
    y0 = lerp(wy, x00, x10)
    y1 = lerp(wy, x01, x11)
    return lerp(wz, y0, y1)


def _octaves(omega: float, octaves: int):
    """The (lacunarity, gain) of each octave, accumulated in float64 on
    the host as the reference's Python loop accumulates them."""
    lam, o, out = 1.0, 1.0, []
    for _ in range(max(int(octaves), 1)):
        out.append((lam, o))
        lam *= 1.99
        o *= omega
    return out


def _noise_stack(ps: Sequence):
    """noise3 of several (..., 3) inputs as one stacked call."""
    return noise3(torch.stack(list(ps))).unbind(0)


def _octave_sum(p, omega: float, octaves: int, absolute: bool, extra=()):
    """The reference's FBm (absolute=False) or Turbulence sum of p, with
    every octave's noise evaluated in one stacked call (and any `extra`
    inputs' noise in the same call, returned after the sum)."""
    octs = _octaves(omega, octaves)
    ns = _noise_stack([p * lam for lam, _ in octs] + list(extra))
    out = 0.0
    for (_, o), n in zip(octs, ns):
        out = out + o * (torch.abs(n) if absolute else n)
    return out, ns[len(octs):]


def fbm(p, omega: float, octaves: int):
    """texture.cpp FBm with an explicit octave count."""
    return _octave_sum(p, omega, octaves, False)[0]


def turbulence(p, omega: float, octaves: int):
    return _octave_sum(p, omega, octaves, True)[0]


# -------------------------------------------------------------------------
# mappings (texture.cpp TextureMapping2D/3D)
# -------------------------------------------------------------------------

def _affine3(m: np.ndarray, p):
    """p @ m[:3, :3].T + m[:3, 3] written out term by term (float32, no
    TF32), so a lane rounds alike in any batch: the reference's XLA dot
    rounds by the batch shape, an ulp or two from this."""
    m = np.asarray(m, np.float32)
    rows = [((p[..., 0] * float(m[i, 0]) + p[..., 1] * float(m[i, 1]))
             + p[..., 2] * float(m[i, 2])) + float(m[i, 3]) for i in range(3)]
    return torch.stack(rows, dim=-1)


def _map2d(m: dict, uv, p):
    kind = m.get("type", "uv")
    if kind == "uv":
        return m["su"] * uv[..., 0] + m["du"], m["sv"] * uv[..., 1] + m["dv"]
    if kind == "planar":
        v1 = np.asarray(m["v1"], np.float32)
        v2 = np.asarray(m["v2"], np.float32)

        def dotc(v):
            return (p[..., 0] * float(v[0]) + p[..., 1] * float(v[1])) + p[..., 2] * float(v[2])

        return dotc(v1) + m["du"], dotc(v2) + m["dv"]
    pt = _affine3(m["world_to_texture"].m, p)
    phi = torch.atan2(pt[..., 1], pt[..., 0])
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    if kind == "spherical":
        r = torch.sqrt((pt[..., 0] * pt[..., 0] + pt[..., 1] * pt[..., 1])
                       + pt[..., 2] * pt[..., 2])
        theta = torch.acos(torch.clamp(pt[..., 2] / torch.clamp(r, min=1e-20), -1, 1))
        return _divc(theta, np.pi), _divc(phi, 2 * np.pi)
    # cylindrical
    return _divc(phi, 2 * np.pi), pt[..., 2]


def _map3d(m: dict, p):
    return _affine3(m["world_to_texture"].m, p)


# -------------------------------------------------------------------------
# imagemap atlas (host numpy: the reference's code)
# -------------------------------------------------------------------------

def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _build_pyramid(img: np.ndarray) -> List[np.ndarray]:
    """Box-filtered mip chain (mipmap.h resampleWeights simplified to the
    power-of-two box reduction; non-pow2 levels use edge-clamped halving)."""
    levels = [img.astype(np.float32)]
    cur = levels[0]
    while max(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        pad = cur[: h2 * 2, : w2 * 2]
        if pad.shape[0] < 2 * h2 or pad.shape[1] < 2 * w2:
            pad = np.pad(
                cur,
                ((0, 2 * h2 - h), (0, 2 * w2 - w), (0, 0)),
                mode="edge",
            )[: 2 * h2, : 2 * w2]
        nxt = 0.25 * (
            pad[0::2, 0::2] + pad[1::2, 0::2] + pad[0::2, 1::2] + pad[1::2, 1::2]
        )
        levels.append(nxt.astype(np.float32))
        cur = nxt
    return levels


class _AtlasBuilder:
    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.size = 0
        self._cache = {}

    def add_image(self, path: str, gamma: bool, scale: float):
        """Returns [(offset, w, h)] per mip level."""
        key = (path, bool(gamma), float(scale))
        if key in self._cache:
            return self._cache[key]
        from tpu_pbrt_torch.utils.imageio import read_image

        img = np.asarray(read_image(path), np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        img = img[..., :3]
        if gamma:
            img = _srgb_to_linear(img)
        img = img * scale
        levels = []
        for lv in _build_pyramid(img):
            h, w = lv.shape[:2]
            levels.append((self.size, w, h))
            self.chunks.append(lv.reshape(-1, 3))
            self.size += w * h
        self._cache[key] = levels
        return levels

    def finish(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros((1, 3), np.float32)
        return np.concatenate(self.chunks, 0)


# -------------------------------------------------------------------------
# lookups
# -------------------------------------------------------------------------

def _bilinear(atlas, off, w, h, u, v, wrap: str):
    """One bilinear tap per lane from a level stored row-major at
    atlas[off:off+w*h]; off, w, h are ints or per-lane int64 tensors."""
    wf = w.to(u.dtype) if torch.is_tensor(w) else w
    hf = h.to(u.dtype) if torch.is_tensor(h) else h
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def wrapc(i, n):
        i = _i32(i)
        if wrap == "repeat":
            return torch.remainder(i, n)
        return torch.minimum(torch.clamp(i, min=0), n - 1) if torch.is_tensor(n) else \
            torch.clamp(i, 0, n - 1)

    def tap(ix, iy):
        idx = off + wrapc(iy, h) * w + wrapc(ix, w)
        return atlas[idx.clamp(0, atlas.shape[0] - 1)]

    c = (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
         + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
         + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
         + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])
    if wrap == "black":
        inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
        c = torch.where(inside[..., None], c, torch.zeros_like(c))
    return c


class _Levels:
    """An imagemap's mip levels as host tuples and, per device, as
    (offset, width, height) int64 tensors a lane gathers its level from."""

    def __init__(self, levels):
        self.levels = levels
        self.n = len(levels)
        self._dev: Dict[Any, tuple] = {}

    def on(self, device):
        if device not in self._dev:
            t = torch.tensor(self.levels, dtype=torch.int64, device=device)
            self._dev[device] = (t[:, 0], t[:, 1], t[:, 2])
        return self._dev[device]


def _trilerp(atlas, lv: _Levels, u, v, lodc, wrap: str):
    """One trilinear tap per lane: bilinear at the lane's floor and next
    level (both gathered per lane, looked up in one batched call), lerped.
    A level outside the pyramid contributes 0, as the reference's level
    select leaves it."""
    l0 = _i32(torch.floor(lodc))
    fl = lodc - l0.to(torch.float32)
    l1 = torch.minimum(l0 + 1, torch.full_like(l0, lv.n - 1))
    off, w, h = lv.on(atlas.device)
    lvl = torch.stack([l0, l1])
    ok = (lvl >= 0) & (lvl < lv.n)
    li = lvl.clamp(0, lv.n - 1)
    both = _bilinear(atlas, off[li], w[li], h[li], torch.stack([u, u]), torch.stack([v, v]), wrap)
    both = torch.where(ok[..., None], both, torch.zeros_like(both))
    return both[0] * (1.0 - fl)[..., None] + both[1] * fl[..., None]


def _ewa(atlas, lv: _Levels, m: dict, wrap: str, u, v, lod):
    """The EWA-class anisotropic lookup for a (..., 4) surface-uv
    footprint (the reference's ev_image), all EWA_TAPS taps in one
    batched trilinear call."""
    if m.get("type", "uv") == "uv":
        su = abs(float(m.get("su", 1.0)))
        sv = abs(float(m.get("sv", 1.0)))
    else:
        su = sv = 1.0
    dux, dvx = lod[..., 0] * su, lod[..., 1] * sv
    duy, dvy = lod[..., 2] * su, lod[..., 3] * sv
    l2x = dux * dux + dvx * dvx
    l2y = duy * duy + dvy * dvy
    x_major = l2x >= l2y
    major = torch.sqrt(torch.clamp(torch.maximum(l2x, l2y), min=1e-16))
    minor = torch.sqrt(torch.clamp(torch.minimum(l2x, l2y), min=0.0))
    minor = torch.maximum(minor, _divc(major, MAX_ANISO))
    mu = torch.where(x_major, dux, duy)
    mv = torch.where(x_major, dvx, dvy)
    lodc = torch.clamp((lv.n - 1) + torch.log2(torch.clamp(minor, min=1e-8)), 0.0, lv.n - 1.0)
    fs = [(t + 0.5) / EWA_TAPS - 0.5 for t in range(EWA_TAPS)]  # (-0.5, 0.5)
    # pbrt's EWA Gaussian falloff (alpha = 2) over the normalized ellipse
    # coordinate r = 2f
    wgts = [float(np.exp(-2.0 * (2.0 * f) ** 2)) for f in fs]
    taps = _trilerp(atlas, lv, torch.stack([u + f * mu for f in fs]),
                    torch.stack([v + f * mv for f in fs]),
                    torch.stack([lodc] * EWA_TAPS), wrap)
    acc = torch.zeros(u.shape + (3,), dtype=torch.float32, device=u.device)
    wsum = 0.0
    for wgt, tap in zip(wgts, taps.unbind(0)):
        acc = acc + wgt * tap
        wsum += wgt
    return _divc(acc, wsum)


# -------------------------------------------------------------------------
# node compilation
# -------------------------------------------------------------------------

class _OnDevice:
    """A host float32 constant, copied once to each device that reads it."""

    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self._dev: Dict[Any, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        if device not in self._dev:
            self._dev[device] = torch.from_numpy(self.value.copy()).to(device)
        return self._dev[device]


#: marble.cpp's color ramp as the reference approximates it
_MARBLE = np.asarray(
    [[0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.5, 0.5, 0.5],
     [0.6, 0.59, 0.58], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.2, 0.2, 0.33],
     [0.58, 0.58, 0.6]], np.float32)
_MARBLE_RAMP = _OnDevice(_MARBLE)


def _full(uv, c):
    return torch.full(uv.shape[:-1] + (3,), c, dtype=torch.float32, device=uv.device)


def _gray(x):
    return x[..., None] * torch.ones(3, dtype=x.dtype, device=x.device)


def _compile_node(node, atlas: _AtlasBuilder) -> Callable:
    """node -> fn(atlas_buf, uv, p, lod) -> (..., 3). Constants and float
    scalars broadcast; recursion composes sub-textures (scale/mix/checker
    arms are themselves texture nodes)."""
    if node is None:
        return lambda a, uv, p, lod: _full(uv, 0.0)
    if isinstance(node, (int, float)):
        c = float(node)
        return lambda a, uv, p, lod: _full(uv, c)
    if isinstance(node, np.ndarray) or (
        isinstance(node, (list, tuple)) and node and isinstance(node[0], (int, float))
    ):
        c = np.asarray(node, np.float32).reshape(-1)
        c3 = _OnDevice(np.full(3, c[0]) if c.size == 1 else c[:3])
        return lambda a, uv, p, lod: c3.on(uv.device).expand(uv.shape[:-1] + (3,))
    kind = node[0]
    if kind in ("const", "constf"):
        return _compile_node(node[1], atlas)
    if kind == "scale":
        f1 = _compile_node(node[1], atlas)
        f2 = _compile_node(node[2], atlas)
        return lambda a, uv, p, lod: f1(a, uv, p, lod) * f2(a, uv, p, lod)
    if kind == "mix":
        f1 = _compile_node(node[1], atlas)
        f2 = _compile_node(node[2], atlas)
        fa = _compile_node(node[3], atlas)

        def ev_mix(a, uv, p, lod):
            t = fa(a, uv, p, lod)
            return (1.0 - t) * f1(a, uv, p, lod) + t * f2(a, uv, p, lod)

        return ev_mix
    if kind == "bilerp":
        d = node[1]
        f00, f01 = _compile_node(d["v00"], atlas), _compile_node(d["v01"], atlas)
        f10, f11 = _compile_node(d["v10"], atlas), _compile_node(d["v11"], atlas)
        m = d["mapping"]

        def ev_bilerp(a, uv, p, lod):
            u, v = _map2d(m, uv, p)
            return ((1 - u)[..., None] * (1 - v)[..., None] * f00(a, uv, p, lod)
                    + (1 - u)[..., None] * v[..., None] * f01(a, uv, p, lod)
                    + u[..., None] * (1 - v)[..., None] * f10(a, uv, p, lod)
                    + u[..., None] * v[..., None] * f11(a, uv, p, lod))

        return ev_bilerp
    if kind == "imagemap":
        d = node[1]
        lv = _Levels(atlas.add_image(d["filename"], d["gamma"], d["scale"]))
        m = d["mapping"]
        wrap = d.get("wrap", "repeat")

        def ev_image(a, uv, p, lod):
            u, v = _map2d(m, uv, p)
            if lod is None:
                off, w, h = lv.levels[0]
                return _bilinear(a, off, w, h, u, v, wrap)
            if lod.ndim == u.ndim + 1:
                # the (..., 4) surface-uv footprint; the uv mapping's su/sv
                # scale it into texture space (UVMapping2D::Map)
                return _ewa(a, lv, m, wrap, u, v, lod)
            # a scalar lod (isotropic width): one trilinear tap
            map_scale = max(abs(float(m.get("su", 1.0))), abs(float(m.get("sv", 1.0)))) \
                if m.get("type", "uv") == "uv" else 1.0
            lvl = (lv.n - 1) + torch.log2(torch.clamp(lod * map_scale, min=1e-8))
            return _trilerp(a, lv, u, v, torch.clamp(lvl, 0.0, lv.n - 1.0), wrap)

        return ev_image
    if kind == "uv":
        m = node[1]["mapping"]

        def ev_uv(a, uv, p, lod):
            u, v = _map2d(m, uv, p)
            return torch.stack([u - torch.floor(u), v - torch.floor(v), torch.zeros_like(u)], -1)

        return ev_uv
    if kind == "checkerboard":
        d = node[1]
        f1, f2 = _compile_node(d["tex1"], atlas), _compile_node(d["tex2"], atlas)
        m = d["mapping"]
        if d["dim"] == 2:

            def ev_check(a, uv, p, lod):
                u, v = _map2d(m, uv, p)
                sel = torch.remainder(_i32(torch.floor(u) + torch.floor(v)), 2) == 0
                return torch.where(sel[..., None], f1(a, uv, p, lod), f2(a, uv, p, lod))

            return ev_check

        def ev_check3(a, uv, p, lod):
            fl = _i32(torch.floor(_map3d(m, p)))
            s = (fl[..., 0] + fl[..., 1]) + fl[..., 2]
            return torch.where((torch.remainder(s, 2) == 0)[..., None], f1(a, uv, p, lod),
                               f2(a, uv, p, lod))

        return ev_check3
    if kind == "dots":
        d = node[1]
        fi, fo = _compile_node(d["inside"], atlas), _compile_node(d["outside"], atlas)
        m = d["mapping"]

        def ev_dots(a, uv, p, lod):
            u, v = _map2d(m, uv, p)
            sc, tc = torch.floor(u + 0.5), torch.floor(v + 0.5)
            cell = torch.stack([sc, tc, torch.zeros_like(sc)], -1)
            n0, n1, n2 = _noise_stack([cell + 0.5, cell * 1.5 + 10.0, cell * 2.5 + 20.0])
            has_dot = n0 > 0.0
            rad = 0.35
            maxshift = 0.5 - rad
            cx = sc + maxshift * n1
            cy = tc + maxshift * n2
            d2 = (u - cx) * (u - cx) + (v - cy) * (v - cy)
            sel = has_dot & (d2 < rad * rad)
            return torch.where(sel[..., None], fi(a, uv, p, lod), fo(a, uv, p, lod))

        return ev_dots
    if kind in ("fbm", "wrinkled", "windy", "marble"):
        d = node[1]
        m = d["mapping"]
        octaves = int(d.get("octaves", 8))
        omega = float(d.get("roughness", 0.5))
        if kind == "fbm":
            return lambda a, uv, p, lod: _gray(fbm(_map3d(m, p), omega, octaves))
        if kind == "wrinkled":
            return lambda a, uv, p, lod: _gray(turbulence(_map3d(m, p), omega, octaves))
        if kind == "windy":

            def ev_windy(a, uv, p, lod):
                pt = _map3d(m, p)
                # fbm(0.1 pt, 0.5, 3) and fbm(pt, 0.5, 6) in one noise call
                low_octs = _octaves(0.5, 3)
                height, low = _octave_sum(pt, 0.5, 6, False,
                                          extra=[(0.1 * pt) * lam for lam, _ in low_octs])
                strength = 0.0
                for (_, o), n in zip(low_octs, low):
                    strength = strength + o * n
                return _gray(torch.abs(strength) * torch.abs(height))

            return ev_windy
        scale = float(d.get("scale", 1.0))
        variation = float(d.get("variation", 0.2))

        def ev_marble(a, uv, p, lod):
            pt = _map3d(m, p) * scale
            marble = pt[..., 1] + variation * fbm(pt, omega, octaves)
            t = 0.5 + 0.5 * torch.sin(marble)
            nseg = _MARBLE.shape[0] - 3
            fi = torch.clamp(t * nseg, 0.0, nseg - 1e-4)
            i0 = _i32(fi)
            ft = (fi - i0.to(torch.float32))[..., None]
            ramp = _MARBLE_RAMP.on(p.device)
            return (1 - ft) * ramp[i0 + 1] + ft * ramp[i0 + 2]

        return ev_marble
    # unknown node: mid gray (textures.py already warned at parse)
    return lambda a, uv, p, lod: _full(uv, 0.5)


class TextureTable:
    """The compiled evaluators of a scene's textures. Called as
    evaluate(atlas, tid (R,), uv (R,2), p (R,3), lod=None, tids=None) ->
    (R,3): lanes with tid < 0 (or an id outside `tids`, the ids the
    calling slot can hold) return 0, as the reference's masked sum does
    (callers keep the constant-folded parameter there)."""

    def __init__(self, fns: List[Callable]):
        self.fns = fns

    def __len__(self):
        return len(self.fns)

    def __call__(self, atlas, tid, uv, p, lod=None, tids=None):
        n = len(self.fns)
        out = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32, device=uv.device)
        cand = [i for i in (range(n) if tids is None else tids) if 0 <= i < n]
        if not cand or out.numel() == 0:
            return out
        # lanes per texture id (one host read), then each texture on its lanes
        key = torch.where((tid >= 0) & (tid < n), tid.to(torch.int64) + 1,
                          torch.zeros_like(tid, dtype=torch.int64))
        counts = torch.bincount(key, minlength=n + 1).tolist()
        order = torch.argsort(key, stable=True)
        starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
        for i in cand:
            lo, hi = starts[i + 1], starts[i + 2]
            if hi == lo:
                continue
            lanes = order[lo:hi]
            val = self.fns[i](atlas, uv[lanes], p[lanes], None if lod is None else lod[lanes])
            if val.ndim == out.ndim - 1:
                val = _gray(val)
            out[lanes] = val.to(torch.float32)
        return out


def build_texture_table(nodes: List[Any]) -> Tuple[np.ndarray, TextureTable]:
    """Deferred texture nodes -> (the atlas ndarray, their TextureTable)."""
    atlas = _AtlasBuilder()
    fns = [_compile_node(n, atlas) for n in nodes]
    return atlas.finish(), TextureTable(fns)
