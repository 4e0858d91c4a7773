"""Counter-based sampling, warps, Distribution1D and MIS (port of
tpu_pbrt/core/sampling.py, the parts the (0,2)-sequence sampler and the
matte path estimator use).

Every random number is a pure hash of (pixel, sample, dimension), so the
port draws exactly the reference's sample streams. The reference hashes
in uint32 with wraparound and LOGICAL shifts; torch has no full uint32
arithmetic, so the port computes in int64 masked to 32 bits, with the
32 x 32-bit multiplies split into 16-bit halves so no int64 product can
overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ONE_MINUS_EPSILON = float(np.float32(0.99999994))
_M32 = 0xFFFFFFFF
_TO_UNIT = 2.3283064365386963e-10  # 2^-32


def _u32(x, device=None):
    """Any integer tensor / python int -> int64 tensor holding its uint32
    value (negative int32 values wrap, as astype(uint32) does)."""
    if not torch.is_tensor(x):
        x = torch.tensor(int(x), dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def _mul32(a, b):
    """(a * b) mod 2^32 for uint32 values held in int64 (b: int or tensor)."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _dev(parts):
    for p in parts:
        if torch.is_tensor(p):
            return p.device
    return None


def _mix(h, v):
    """One round of the avalanche combine (uint32)."""
    h = _mul32(h ^ v, 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def hash_u32(*parts) -> torch.Tensor:
    """Hash integer parts to uint32 (as int64 values in [0, 2^32))."""
    dev = _dev(parts)
    h = torch.tensor(0x2545F491, dtype=torch.int64, device=dev)
    for p in parts:
        h = _mix(h, _u32(p, dev))
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_float(*parts) -> torch.Tensor:
    """U[0,1) from hashed parts; strictly < 1 (pbrt OneMinusEpsilon clamp)."""
    u = hash_u32(*parts)
    f = (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(f, max=ONE_MINUS_EPSILON)


def uniform_2d(*parts):
    """Two independent U[0,1) streams distinguished by a trailing salt."""
    return uniform_float(*parts, 0x5B3C), uniform_float(*parts, 0xA7E9)


# -------------------------------------------------------------------------
# Warps (pbrt sampling.cpp)
# -------------------------------------------------------------------------

def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map; returns (x, y)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    theta = torch.where(
        use_x,
        (np.pi / 4.0) * (oy / torch.where(ox == 0.0, one, ox)),
        (np.pi / 2.0) - (np.pi / 4.0) * (ox / torch.where(oy == 0.0, one, oy)),
    )
    zero = torch.zeros_like(ox)
    x = torch.where(degenerate, zero, r * torch.cos(theta))
    y = torch.where(degenerate, zero, r * torch.sin(theta))
    return x, y


def cosine_sample_hemisphere(u1, u2):
    """Malley's method; returns direction (...,3) in local frame, z up."""
    x, y = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * (1.0 / np.pi)


def uniform_sample_triangle(u1, u2):
    """Returns barycentrics (b0, b1) (sqrt warp)."""
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


# -------------------------------------------------------------------------
# Stateless per-pixel sample-order shuffle (Kensler's hash permutation)
# -------------------------------------------------------------------------

def permutation_element(i, n: int, seed):
    """Stateless random permutation of [0, n): an invertible mix
    cycle-walked on the next power of two, 16 fixed masked rounds."""
    i = _u32(i)
    p = _u32(seed, i.device)
    w = (int(n) - 1) & _M32
    for sh in (1, 2, 4, 8, 16):
        w |= w >> sh

    def mix(i):
        i = i ^ p
        i = _mul32(i, 0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = _mul32(i, 0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = _mul32(i, 1 | (p >> 27))
        i = _mul32(i, 0x6935FA69)
        i = i ^ ((i & w) >> 11)
        i = _mul32(i, 0x74DCCA23)
        i = i ^ (p >> 2)
        i = _mul32(i, 0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0xC860A3DF)
        i = i & w
        return i ^ (i >> 5)

    y = mix(i)
    for _ in range(15):
        y = torch.where(y >= n, mix(y), y)
    return ((torch.clamp(y, max=int(n) - 1) + p) & _M32) % int(n)


# -------------------------------------------------------------------------
# Radical inverse / the (0,2)-sequence (pbrt lowdiscrepancy.h)
# -------------------------------------------------------------------------

def reverse_bits_32(n):
    n = _u32(n)
    n = ((n << 16) | (n >> 16)) & _M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _to_unit(bits):
    return torch.clamp(bits.to(torch.float32) * _TO_UNIT, max=ONE_MINUS_EPSILON)


def radical_inverse_base2(n, scramble=0):
    """Van der Corput, with optional XOR scramble (uint32)."""
    bits = reverse_bits_32(n)
    return _to_unit(bits ^ _u32(scramble, bits.device))


def sobol_2d(n, scramble_x=0, scramble_y=0):
    """First two dimensions of the Sobol' sequence ((0,2)-sequence)."""
    n = _u32(n)
    x = reverse_bits_32(n) ^ _u32(scramble_x, n.device)
    v = 1 << 31
    y = torch.zeros_like(n)
    for i in range(32):
        y = torch.where(((n >> i) & 1) != 0, y ^ v, y)
        v = v ^ (v >> 1)
    y = y ^ _u32(scramble_y, n.device)
    return _to_unit(x), _to_unit(y)


def sample_1d(kind: str, spp: int, px, py, s, salt):
    """One U[0,1) draw for dimension `salt` under sampler `kind`
    ("02" = the (0,2)-sequence family; "random" or spp <= 1 = hashed)."""
    if kind == "random" or spp <= 1:
        return uniform_float(px, py, s, salt)
    if kind != "02":
        raise NotImplementedError(f"sampler kind {kind!r} is not ported yet")
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x7F2))
    return radical_inverse_base2(sp, hash_u32(px, py, salt, 0x9D3))


def sample_2d(kind: str, spp: int, px, py, s, salt):
    """A consumed-together 2D pair for dimension pair `salt`."""
    if kind == "random" or spp <= 1:
        return uniform_float(px, py, s, salt), uniform_float(px, py, s, salt + 0x151)
    if kind != "02":
        raise NotImplementedError(f"sampler kind {kind!r} is not ported yet")
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x3C5))
    return sobol_2d(sp, hash_u32(px, py, salt, 0x8E7), hash_u32(px, py, salt, 0xB19))


def normalize_sampler_name(name: str) -> str:
    """Scene-file sampler name -> dispatch kind (api.cpp MakeSampler),
    restricted to the samplers this package implements."""
    n = (name or "").lower()
    if n == "random":
        return "random"
    if n in ("lowdiscrepancy", "02sequence", "zerotwosequence"):
        return "02"
    from tpu_pbrt_torch.utils.error import PbrtError

    raise PbrtError(
        f'sampler "{name}" is not ported to tpu_pbrt_torch yet '
        '(ported: "zerotwosequence", "random")'
    )


# -------------------------------------------------------------------------
# Distribution1D (pbrt sampling.h) — built on the host, sampled on device
# -------------------------------------------------------------------------

class Distribution1D(NamedTuple):
    """func: (N,), cdf: (N+1,), func_int: () — f32 tensors."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @staticmethod
    def build_numpy(f):
        """(func, cdf, func_int) as f32 numpy, the reference's build."""
        f = np.asarray(f, dtype=np.float64)
        n = len(f)
        cdf = np.zeros(n + 1)
        cdf[1:] = np.cumsum(f) / n
        func_int = cdf[-1]
        if func_int == 0:
            cdf[1:] = np.arange(1, n + 1) / n
        else:
            cdf[1:] /= func_int
        return (np.asarray(f, np.float32), np.asarray(cdf, np.float32),
                np.float32(func_int))

    @staticmethod
    def build(f, device="cpu") -> "Distribution1D":
        func, cdf, func_int = Distribution1D.build_numpy(f)
        return Distribution1D(
            torch.from_numpy(func).to(device), torch.from_numpy(cdf).to(device),
            torch.tensor(func_int, dtype=torch.float32, device=device),
        )

    @property
    def count(self):
        return self.func.shape[0]

    def sample_discrete(self, u):
        """Returns (offset, pmf)."""
        offset = torch.clamp(
            torch.searchsorted(self.cdf, u.contiguous(), right=True) - 1, 0, self.count - 1
        )
        pmf = torch.where(
            self.func_int > 0,
            self.func[offset] / torch.clamp(self.func_int * self.count, min=1e-20),
            torch.zeros_like(u),
        )
        return offset, pmf

    def discrete_pdf(self, index):
        return self.func[index] / torch.clamp(self.func_int * self.count, min=1e-20)


class Distribution2D(NamedTuple):
    """Piecewise-constant 2D distribution (pbrt sampling.h Distribution2D):
    conditional rows plus a marginal over their integrals, built on the
    host in numpy as the reference builds it and uploaded f32.

    cond_func / cond_cdf: (H, W) / (H, W + 1); cond_int (H,); the marginal
    marg_func (H,), marg_cdf (H + 1,), marg_int ()."""

    cond_func: torch.Tensor
    cond_cdf: torch.Tensor
    cond_int: torch.Tensor
    marg_func: torch.Tensor
    marg_cdf: torch.Tensor
    marg_int: torch.Tensor

    @staticmethod
    def build_numpy(f) -> tuple:
        """The six tables as f32 numpy, the reference's build."""
        f = np.asarray(f, dtype=np.float64)
        h, w = f.shape
        cond_cdf = np.zeros((h, w + 1))
        cond_cdf[:, 1:] = np.cumsum(f, axis=1) / w
        cond_int = cond_cdf[:, -1].copy()
        safe = np.where(cond_int == 0, 1.0, cond_int)
        cond_cdf[:, 1:] = np.where(
            cond_int[:, None] == 0,
            np.arange(1, w + 1)[None, :] / w,
            cond_cdf[:, 1:] / safe[:, None],
        )
        mf, mc, mi = Distribution1D.build_numpy(cond_int)
        return (np.asarray(f, np.float32), np.asarray(cond_cdf, np.float32),
                np.asarray(cond_int, np.float32), mf, mc, np.float32(mi))

    @staticmethod
    def build(f, device="cpu") -> "Distribution2D":
        return Distribution2D(*(torch.from_numpy(np.asarray(a)).to(device)
                                for a in Distribution2D.build_numpy(f)))

    def sample_continuous(self, u1, u2):
        """Returns ((u, v), pdf)."""
        h, w = self.cond_func.shape
        zero = torch.zeros_like(u2)
        # marginal (rows)
        row = torch.clamp(
            torch.searchsorted(self.marg_cdf, u2.contiguous(), right=True) - 1, 0, h - 1)
        mc0 = self.marg_cdf[row]
        mc1 = self.marg_cdf[row + 1]
        dv = torch.where(mc1 > mc0, (u2 - mc0) / torch.clamp(mc1 - mc0, min=1e-20), zero)
        pdf_v = torch.where(self.marg_int > 0,
                            self.marg_func[row] / torch.clamp(self.marg_int, min=1e-20), zero)
        v = (row.to(torch.float32) + dv) / h
        # conditional (columns within the row): a count-based search
        cdf_row = self.cond_cdf[row]  # (..., W + 1)
        col = torch.clamp((cdf_row <= u1[..., None]).sum(dim=-1) - 1, 0, w - 1)
        cc0 = torch.gather(cdf_row, -1, col[..., None])[..., 0]
        cc1 = torch.gather(cdf_row, -1, col[..., None] + 1)[..., 0]
        du = torch.where(cc1 > cc0, (u1 - cc0) / torch.clamp(cc1 - cc0, min=1e-20), zero)
        ci = self.cond_int[row]
        fval = self.cond_func[row, col]
        pdf_u = torch.where(ci > 0, fval / torch.clamp(ci, min=1e-20), zero)
        uu = (col.to(torch.float32) + du) / w
        return (uu, v), pdf_u * pdf_v

    def pdf(self, u, v):
        """Pdf of (u, v) in [0, 1)^2 (pbrt Distribution2D::Pdf). The f32 ->
        int conversion saturates like XLA's, so NaN and huge inputs of
        masked lanes clamp instead of wrapping."""
        h, w = self.cond_func.shape
        iu = torch.nan_to_num(u * w, nan=0.0).clamp(-1.0, float(w)).to(torch.int64).clamp(0, w - 1)
        iv = torch.nan_to_num(v * h, nan=0.0).clamp(-1.0, float(h)).to(torch.int64).clamp(0, h - 1)
        return self.cond_func[iv, iu] / torch.clamp(self.marg_int, min=1e-20)
