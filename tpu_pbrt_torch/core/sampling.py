"""Counter-based sampling, warps, the five samplers' streams,
Distribution1D/2D and MIS (port of tpu_pbrt/core/sampling.py).

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

from tpu_pbrt_torch.core import xla_math as _xm
from tpu_pbrt_torch.core.xla_math import fmac as _fmac, sqrt as _sqrt

ONE_MINUS_EPSILON = float(np.float32(0.99999994))
_M32 = 0xFFFFFFFF
_TO_UNIT = 2.3283064365386963e-10  # 2^-32


def _u32(x):
    """Any integer tensor / python int -> its uint32 value (negative int32
    values wrap, as astype(uint32) does): an int64 tensor, or a Python int
    for a Python int (a host constant stays on the host: a device tensor
    made of it would be a copy the host waits for on CUDA)."""
    if not torch.is_tensor(x):
        return int(x) & _M32
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
    """Hash integer parts to uint32 (as int64 values in [0, 2^32)). The
    arithmetic on Python ints and on int64 tensors is the same, exact
    below 2^63; the state becomes a tensor at the first tensor part."""
    h = 0x2545F491
    for p in parts:
        h = _mix(h, _u32(p))
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    if not torch.is_tensor(h):
        h = torch.tensor(h, dtype=torch.int64, device=_dev(parts))
    return h


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
    # pi/2 - (pi/4) q with the product fused into the difference, as the
    # compiled reference rounds it
    q = ox / torch.where(oy == 0.0, one, oy)
    theta = torch.where(
        use_x,
        (np.pi / 4.0) * (oy / torch.where(ox == 0.0, one, ox)),
        _fmac(-q, np.pi / 4.0, torch.full_like(q, np.pi / 2.0)),
    )
    zero = torch.zeros_like(ox)
    x = torch.where(degenerate, zero, r * _xm.cos(theta))
    y = torch.where(degenerate, zero, r * _xm.sin(theta))
    return x, y


def cosine_sample_hemisphere(u1, u2):
    """Malley's method; returns direction (...,3) in local frame, z up."""
    x, y = concentric_sample_disk(u1, u2)
    # (1 - x x) - y y with both products contracted, as compiled
    z = _sqrt(torch.clamp(_fmac(-y, y, _fmac(-x, x, 1.0)), min=0.0))
    return torch.stack([x, y, z], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * (1.0 / np.pi)


def uniform_sample_hemisphere(u1, u2):
    z = u1
    r = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_HEMISPHERE_PDF = 1.0 / (2.0 * np.pi)
UNIFORM_SPHERE_PDF = 1.0 / (4.0 * np.pi)


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * np.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_triangle(u1, u2):
    """Returns barycentrics (b0, b1) (sqrt warp)."""
    su0 = _sqrt(u1)
    return 1.0 - su0, u2 * su0


def uniform_sample_cone(u1, u2, cos_theta_max):
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = _sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * np.pi * u2
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * np.pi * torch.clamp(1.0 - cos_theta_max, min=1e-9))


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / torch.clamp(nf * f_pdf + ng * g_pdf, min=1e-20)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    # g g contracted into the sum (f f has two uses), as compiled
    return (f * f) / torch.clamp(_fmac(g, g, f * f), min=1e-20)


# -------------------------------------------------------------------------
# Stateless per-pixel sample-order shuffle (Kensler's hash permutation)
# -------------------------------------------------------------------------

def permutation_element(i, n: int, seed):
    """Stateless random permutation of [0, n): an invertible mix
    cycle-walked on the next power of two, 16 fixed masked rounds."""
    i = _u32(i)
    p = _u32(seed)
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
    return _to_unit(bits ^ _u32(scramble))


def sobol_2d(n, scramble_x=0, scramble_y=0):
    """First two dimensions of the Sobol' sequence ((0,2)-sequence)."""
    n = _u32(n)
    x = reverse_bits_32(n) ^ _u32(scramble_x)
    v = 1 << 31
    y = torch.zeros_like(n)
    for i in range(32):
        y = torch.where(((n >> i) & 1) != 0, y ^ v, y)
        v = v ^ (v >> 1)
    y = y ^ _u32(scramble_y)
    return _to_unit(x), _to_unit(y)


# -------------------------------------------------------------------------
# Stratified, Halton and Sobol' streams (pbrt stratified.cpp,
# lowdiscrepancy.h, sobol.cpp + sobolmatrices.cpp as the reference
# rebuilds them)
# -------------------------------------------------------------------------

def _div(x, n: int):
    """x / n as an IEEE division on every device (CUDA turns a division by
    a host scalar into a multiply by its reciprocal)."""
    return x / torch.full_like(x, float(n))


def stratified_1d(sample_index, n_strata: int, *key_parts):
    """Jittered stratified sample: cell = perm(sample_index), jitter inside."""
    seed = hash_u32(*key_parts, 0x517A)
    cell = permutation_element(sample_index, n_strata, seed).to(torch.float32)
    u = uniform_float(*key_parts, 0x11D7)
    return torch.clamp(_div(cell + u, n_strata), max=ONE_MINUS_EPSILON)


def stratified_2d(sample_index, sx: int, sy: int, *key_parts):
    """Jittered 2D stratification over an sx x sy grid."""
    seed = hash_u32(*key_parts, 0x2F83)
    cell = permutation_element(sample_index, sx * sy, seed)
    cx = (cell % sx).to(torch.float32)
    cy = torch.div(cell, sx, rounding_mode="floor").to(torch.float32)
    u1 = uniform_float(*key_parts, 0x9E01)
    u2 = uniform_float(*key_parts, 0xC6A3)
    return (torch.clamp(_div(cx + u1, sx), max=ONE_MINUS_EPSILON),
            torch.clamp(_div(cy + u2, sy), max=ONE_MINUS_EPSILON))


def _primes(n):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


#: prime bases for the Halton sampler's dimensions
PRIMES = _primes(64)


def radical_inverse_prime(base: int, n, scramble_seed=None):
    """ScrambledRadicalInverse for a static prime base: digit reversal with
    an optional seeded (a*d + c) mod b digit permutation. The digits
    accumulate in f32, one product and one sum per digit, in the
    reference's order."""
    if base == 2:
        return radical_inverse_base2(n, 0 if scramble_seed is None else scramble_seed)
    n = _u32(n)
    digits = int(np.ceil(32 / np.log2(base)))
    inv_base = np.float32(1.0 / base)
    if scramble_seed is not None:
        seed = _u32(scramble_seed)
        a = seed % (base - 1) + 1  # coprime to the prime base
        c = (seed >> 8) % base
    out = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    factor = np.float32(1.0)
    for _ in range(digits):
        d = n % base
        if scramble_seed is not None:
            d = (a * d + c) % base
        factor = factor * inv_base
        out = out + d.to(torch.float32) * float(factor)
        n = torch.div(n, base, rounding_mode="floor")
    return torch.clamp(out, max=ONE_MINUS_EPSILON)


N_SOBOL_DIMS = 64
_SOBOL_BITS = 32


def _pascal_matrix():
    """MSB-aligned direction numbers of the Pascal (binomial mod 2) matrix:
    the classical Sobol' dimension 2."""
    v = np.zeros(_SOBOL_BITS, np.uint64)
    ms = [1]
    for i in range(1, _SOBOL_BITS):
        m = ms[-1] ^ (ms[-1] << 1)  # x+1 recurrence => Pascal columns
        ms.append(m & ((1 << (i + 1)) - 1))
    for k in range(_SOBOL_BITS):
        v[k] = np.uint64(ms[k]) << np.uint64(31 - k)
    return v


def _lower_tri_scramble(v_cols, seed):
    """A hash-seeded unit-lower-triangular (MSB-first) linear scramble of a
    32-column direction matrix (a linear Owen scramble)."""
    rows = np.zeros(_SOBOL_BITS, np.uint64)
    state = np.uint64(seed * 2654435761 % (1 << 32))
    for p in range(_SOBOL_BITS):
        state = np.uint64((int(state) * 6364136223846793005 + 1442695040888963407) % (1 << 64))
        rand_low = int(state >> np.uint64(33)) & ((1 << (31 - p)) - 1)
        rows[p] = (np.uint64(1) << np.uint64(31 - p)) | np.uint64(rand_low)
    out = np.zeros_like(v_cols)
    for k in range(_SOBOL_BITS):
        acc = np.uint64(0)
        col = int(v_cols[k])
        for p in range(_SOBOL_BITS):
            if (col >> (31 - p)) & 1:
                acc ^= rows[p]
        out[k] = acc
    return out


def _build_sobol_matrices():
    """(N_SOBOL_DIMS, 32) uint32 direction-number table, MSB-aligned: dims
    0/1 van der Corput + Pascal, every later pair (2k, 2k+1) a linearly
    Owen-scrambled copy of that pair."""
    v = np.zeros((N_SOBOL_DIMS, _SOBOL_BITS), np.uint64)
    for k in range(_SOBOL_BITS):
        v[0, k] = np.uint64(1) << np.uint64(31 - k)
    v[1] = _pascal_matrix()
    for pair in range(1, N_SOBOL_DIMS // 2):
        v[2 * pair] = _lower_tri_scramble(v[0], 2 * pair + 17)
        v[2 * pair + 1] = _lower_tri_scramble(v[1], 2 * pair + 18)
    return v.astype(np.uint32)


_SOBOL_CACHE: dict = {}


def _sobol_matrices() -> np.ndarray:
    """The direction-number table, built on the host once per process."""
    if "v" not in _SOBOL_CACHE:
        _SOBOL_CACHE["v"] = _build_sobol_matrices()
    return _SOBOL_CACHE["v"]


def _sobol_table(device) -> torch.Tensor:
    """The table as int64 uint32 values on `device` (cached per device)."""
    key = str(device)
    if key not in _SOBOL_CACHE:
        _SOBOL_CACHE[key] = torch.from_numpy(_sobol_matrices().astype(np.int64)).to(device)
    return _SOBOL_CACHE[key]


def _gf2_inv(mat):
    """Invert a binary matrix (lists of row bitmasks) over GF(2)."""
    n = len(mat)
    a = list(mat)
    inv = [1 << i for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if (a[r] >> col) & 1)
        a[col], a[piv] = a[piv], a[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(n):
            if r != col and ((a[r] >> col) & 1):
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


def _remap_tables(m: int):
    """SobolIntervalToIndex's tables for the 2^m x 2^m pixel grid: (hi, inv)
    as lists of ints (cached per m). inv maps target pixel bits (x << m |
    y) to the low 2m index bits; hi[c] is frame bit c's contribution to
    the pixel bits."""
    key = ("remap", m)
    if key not in _SOBOL_CACHE:
        v = _sobol_matrices()
        fwd = [((int(v[0, c]) >> (32 - m)) << m) | (int(v[1, c]) >> (32 - m))
               for c in range(2 * m)]
        hi = [((int(v[0, c + 2 * m]) >> (32 - m)) << m) | (int(v[1, c + 2 * m]) >> (32 - m))
              for c in range(_SOBOL_BITS - 2 * m)]
        _SOBOL_CACHE[key] = (hi, _gf2_inv(fwd))
    return _SOBOL_CACHE[key]


def sobol_interval_to_index(m: int, frame, px, py):
    """SobolSampler's global index remap: the index whose dims 0/1 land
    sample `frame` in pixel (px, py) of the 2^m x 2^m grid (int64 values;
    the caller keeps them below 2^31, as the reference's int32 does)."""
    frame = frame.to(torch.int64)
    if m == 0:
        return frame
    hi, inv = _remap_tables(m)
    index = frame << (2 * m)
    delta = torch.zeros_like(px, dtype=torch.int64)
    for c, h in enumerate(hi):
        delta = delta ^ (((frame >> c) & 1) * h)
    b = ((px.to(torch.int64) << m) | py.to(torch.int64)) ^ delta
    for c in range(2 * m):
        index = index ^ (((b >> c) & 1) * inv[c])
    return index


def _sobol_raw_bits(index, dim):
    """32-bit Sobol' value of `index` in dimension `dim` (an int or a
    per-lane tensor), before scrambling, as int64 in [0, 2^32)."""
    index = _u32(index)
    table = _sobol_table(index.device)
    if torch.is_tensor(dim):
        cols = table[(dim.to(torch.int64) % N_SOBOL_DIMS)]  # (..., 32)
        col = lambda k: cols[..., k]  # noqa: E731
    else:
        row = table[int(dim) % N_SOBOL_DIMS]
        col = lambda k: row[k]  # noqa: E731
    out = torch.zeros_like(index)
    for k in range(_SOBOL_BITS):
        out = out ^ (((index >> k) & 1) * col(k))
    return out


def _fast_owen(bits, seed):
    """Laine-Karras hash-based nested scramble on MSB-aligned bits."""
    v = reverse_bits_32(bits)
    v = (v + _u32(seed)) & _M32
    for mult in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ _mul32(v, mult)
    return reverse_bits_32(v)


_SOBOL_MAX = float(np.float32(1.0 - 1e-7))


def sobol_sample(index, dim, scramble_seed=None):
    """U[0,1) Sobol' sample of `index` in dimension `dim`, fast-Owen
    scrambled when a seed is given."""
    bits = _sobol_raw_bits(index, dim)
    if scramble_seed is not None:
        bits = _fast_owen(bits, scramble_seed)
    return torch.clamp(bits.to(torch.float32) * _TO_UNIT, max=_SOBOL_MAX)


def sobol_resolution_log2(res_xy) -> int:
    """The SobolSampler's pixel grid: the smallest 2^m x 2^m grid covering
    the film. Returns m."""
    m = 0
    while (1 << m) < max(int(res_xy[0]), int(res_xy[1])):
        m += 1
    return m


def _sobol_dim_draw(px, py, s, salt, which: int, spp: int):
    """Decision-dimension Sobol' draw: pair (2k, 2k+1) for salt k, indexed
    by the per-pixel shuffled sample rank, per-pixel fast-Owen scrambled
    (the padded construction)."""
    n_pairs = N_SOBOL_DIMS // 2 - 1
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x5A11))
    if torch.is_tensor(salt):
        dim = 2 + 2 * (salt.to(torch.int64) % n_pairs) + which
    else:
        dim = 2 + 2 * (int(salt) % n_pairs) + which
    seed = hash_u32(px, py, salt, 0x193 + 0x7FEB * which)
    return sobol_sample(sp, dim, seed)


#: joint 2D bases of the Halton pair dimensions, chosen by salt % 6
_HALTON_PAIRS = [(2, 3), (5, 7), (3, 5), (7, 2), (2, 5), (3, 7)]


def _halton_2d(spp: int, px, py, s, salt):
    """The joint prime-base pair at a shared shuffled index. A per-lane
    (tensor) salt evaluates every pair and selects by salt % 6, which is
    what the reference's lax.switch computes for each lane."""
    seed = hash_u32(px, py, salt, 0x62B)
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0xD47))

    def pair(b1, b2):
        return radical_inverse_prime(b1, sp, seed), radical_inverse_prime(b2, sp, seed >> 7)

    if not torch.is_tensor(salt):
        return pair(*_HALTON_PAIRS[int(salt) % len(_HALTON_PAIRS)])
    which = salt.to(torch.int64) % len(_HALTON_PAIRS)
    u = v = None
    for k, (b1, b2) in enumerate(_HALTON_PAIRS):
        pu, pv = pair(b1, b2)
        u = pu if u is None else torch.where(which == k, pu, u)
        v = pv if v is None else torch.where(which == k, pv, v)
    return u, v


# -------------------------------------------------------------------------
# Sampler plugin dispatch. Every draw is a pure function of (px, py,
# sample index, dimension salt); the kind selects each dimension's stream:
# "random" the counter hash, "stratified" jittered strata shuffled per
# (pixel, dimension), "02" shuffled and scrambled (0,2)-sequence pairs,
# "sobol" the padded Sobol' construction, "halton" per-pixel scrambled
# prime-base pairs. `salt` is an int or a per-lane int tensor.
# -------------------------------------------------------------------------

def sample_1d(kind: str, spp: int, px, py, s, salt):
    """One U[0,1) draw for dimension `salt` under sampler `kind`."""
    if kind == "random" or spp <= 1:
        return uniform_float(px, py, s, salt)
    if kind == "sobol":
        return _sobol_dim_draw(px, py, s, salt, 0, spp)
    if kind == "stratified":
        return stratified_1d(s, spp, px, py, salt)
    if kind == "halton":
        # base 2 with a per-dimension shuffle and XOR scramble; Halton's
        # joint prime-base structure lives in sample_2d's pairs
        sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x6E5))
        return radical_inverse_base2(sp, hash_u32(px, py, salt, 0x4A1))
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x7F2))
    return radical_inverse_base2(sp, hash_u32(px, py, salt, 0x9D3))


def sample_2d(kind: str, spp: int, px, py, s, salt):
    """A consumed-together 2D pair for dimension pair `salt`."""
    if kind == "random" or spp <= 1:
        return uniform_float(px, py, s, salt), uniform_float(px, py, s, salt + 0x151)
    if kind == "sobol":
        return (_sobol_dim_draw(px, py, s, salt, 0, spp),
                _sobol_dim_draw(px, py, s, salt, 1, spp))
    if kind == "stratified":
        sx = max(int(np.sqrt(spp)), 1)
        sy = (spp + sx - 1) // sx  # sx*sy >= spp: the permutation stays a bijection
        return stratified_2d(s, sx, sy, px, py, salt)
    if kind == "halton":
        return _halton_2d(spp, px, py, s, salt)
    sp = permutation_element(s, spp, hash_u32(px, py, salt, 0x3C5))
    return sobol_2d(sp, hash_u32(px, py, salt, 0x8E7), hash_u32(px, py, salt, 0xB19))


def normalize_sampler_name(name: str) -> str:
    """Scene-file sampler name -> dispatch kind (api.cpp MakeSampler):
    "maxmindist" and unknown names warn and take the (0,2)-sequence, as
    the reference does."""
    n = (name or "").lower()
    if n in ("random", "stratified", "halton", "sobol"):
        return n
    if n in ("lowdiscrepancy", "02sequence", "zerotwosequence"):
        return "02"
    from tpu_pbrt_torch.utils.error import Warning as _W

    if n == "maxmindist":
        _W('sampler "maxmindist" has no bespoke generator matrix in this '
           "build; SUBSTITUTING the (0,2)-sequence sampler")
        return "02"
    _W(f'sampler "{name}" unknown; using the (0,2)-sequence sampler')
    return "02"


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
