"""The tabulated Fourier BSDF (port of tpu_pbrt/core/fourierbsdf.py).

pbrt-v3's FourierBSDF and FourierBSDFTable::Read (reflection.{h,cpp}): a
.bsdf file (the SCATFUN v1 binary of layerlab / Jakob-Hanika 2014) holds,
per pair of zenith-cosine knots (muI, muO), a run of cosine-series
coefficients a_k with f(muI, muO, phi) |muI| = sum_k a_k cos(k phi), in 1
(luminance) or 3 (Y, R, B) channels; G is rebuilt with pbrt's constants.
Evaluation blends the 16 neighbouring knot pairs' runs with Catmull-Rom
weights (core/interpolation.py) and sums the blended series.

As in the reference, the variable-length runs are gathered as fixed
m_max windows from the flat coefficient array and masked per run, and
sampling is the reference's deviation from pbrt's SampleFourier Newton
inversion: wi comes from a two-sided cosine distribution and is weighted
by the exact f / pdf (unbiased; more variance on strongly specular
tables).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpu_pbrt_torch.core import xla_math as xm
from tpu_pbrt_torch.core.interpolation import catmull_rom_weights, fourier
from tpu_pbrt_torch.core.sampling import cosine_sample_hemisphere
from tpu_pbrt_torch.utils.error import Error


class FourierTable:
    """One .bsdf table (shared by every fourier material of a scene).
    mu, cdf, a, offset and m are arrays (numpy on the host, tensors after
    `to`); eta, n_channels and m_max are Python scalars (m_max bounds the
    coefficient gather loop)."""

    FIELDS = ("mu", "cdf", "a", "offset", "m")

    def __init__(self, mu, cdf, a, offset, m, eta, n_channels, m_max):
        self.mu = mu  # (nMu,) zenith-cosine knots, ascending in [-1, 1]
        self.cdf = cdf  # (nMu, nMu) marginal CDFs
        self.a = a  # (nCoeffs,) flat coefficients
        self.offset = offset  # (nMu * nMu,) i32 run starts into a
        self.m = m  # (nMu * nMu,) i32 run orders (per-channel stride)
        self.eta = float(eta)
        self.n_channels = int(n_channels)
        self.m_max = int(m_max)

    def to(self, device) -> "FourierTable":
        """The table with its arrays as tensors on `device`."""
        arrs = (torch.as_tensor(getattr(self, f)).to(device) for f in self.FIELDS)
        return FourierTable(*arrs, self.eta, self.n_channels, self.m_max)


def read_bsdf_file(path: str) -> FourierTable:
    """FourierBSDFTable::Read (reflection.cpp): the little-endian SCATFUN
    v1 binary, into a host (numpy) table."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"SCATFUN\x01":
        Error(f'"{path}": not a valid .bsdf (SCATFUN v1) file')
    ints = struct.unpack_from("<9i", data, 8)
    flags, n_mu, n_coeffs, m_max, n_channels, n_bases = ints[:6]
    (eta,) = struct.unpack_from("<f", data, 8 + 36)
    # 4 reserved int32s follow eta
    off = 8 + 36 + 4 + 16
    if flags != 1 or n_bases != 1 or n_channels not in (1, 3):
        Error(f'"{path}": unsupported .bsdf layout '
              f"(flags={flags} bases={n_bases} channels={n_channels})")
    mu = np.frombuffer(data, "<f4", n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(data, "<f4", n_mu * n_mu, off).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    ol = np.frombuffer(data, "<i4", 2 * n_mu * n_mu, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, "<f4", n_coeffs, off)
    return FourierTable(
        mu=np.array(mu, np.float32), cdf=np.array(cdf, np.float32),
        a=np.array(a, np.float32), offset=ol[:, 0].astype(np.int32),
        m=ol[:, 1].astype(np.int32), eta=float(eta), n_channels=int(n_channels),
        m_max=int(ol[:, 1].max()) if len(ol) else 1,
    )


def make_table(mu, values, eta=1.0) -> FourierTable:
    """A one-coefficient-per-pair (phi-constant) host table built
    directly: an azimuthally symmetric BSDF needs only a_0."""
    mu = np.asarray(mu, np.float32)
    n = len(mu)
    vals = np.asarray(values, np.float32).reshape(n, n)
    a = vals.reshape(-1)
    offset = np.arange(n * n, dtype=np.int32)
    m = np.where(np.abs(a) > 0, 1, 0).astype(np.int32)
    # marginal "cdf" rows: the running integral of a_0 over muI per muO
    cdf = np.zeros((n, n), np.float32)
    for o in range(n):
        acc = 0.0
        for i in range(1, n):
            acc += 0.5 * (vals[o, i] + vals[o, i - 1]) * (mu[i] - mu[i - 1])
            cdf[o, i] = acc
    return FourierTable(mu=mu, cdf=cdf, a=a, offset=offset, m=m, eta=float(eta),
                        n_channels=1, m_max=1)


def _cos_dphi(wa, wb):
    """CosDPhi (geometry.h): the cosine of the azimuth difference."""
    waxy = wa[..., 0] * wb[..., 0] + wa[..., 1] * wb[..., 1]
    la = wa[..., 0] * wa[..., 0] + wa[..., 1] * wa[..., 1]
    lb = wb[..., 0] * wb[..., 0] + wb[..., 1] * wb[..., 1]
    denom = xm.sqrt(torch.clamp(la * lb, min=1e-20))
    return torch.clamp(torch.where(denom > 1e-10, waxy / denom, torch.ones_like(waxy)),
                       -1.0, 1.0)


def _blend_coeffs(tab: FourierTable, mu_i, mu_o):
    """The Catmull-Rom blend of the 16 neighbouring coefficient runs:
    (R, n_channels, m_max) dense coefficient rows."""
    n_mu = tab.mu.shape[0]
    ii, *wis = catmull_rom_weights(tab.mu, mu_i)
    io, *wos = catmull_rom_weights(tab.mu, mu_o)
    mmax = tab.m_max
    nc = tab.n_channels
    n_a = tab.a.shape[0]
    ak = torch.zeros(mu_i.shape + (nc, mmax), dtype=torch.float32, device=mu_i.device)
    k = torch.arange(mmax, dtype=torch.int32, device=mu_i.device)
    for a_ in range(4):
        for b in range(4):
            # weight slot a applies to knot (interval - 1 + a)
            w = wos[b] * wis[a_]
            idx = torch.clamp((io - 1 + b) * n_mu + (ii - 1 + a_), 0, n_mu * n_mu - 1).long()
            start = tab.offset[idx]
            mlen = tab.m[idx]
            for c in range(nc):
                pos = torch.clamp(start[..., None] + c * mlen[..., None] + k, 0, n_a - 1)
                run = torch.where(k < mlen[..., None], tab.a[pos.long()],
                                  torch.zeros((), dtype=torch.float32, device=mu_i.device))
                ak[..., c, :] = ak[..., c, :] + w[..., None] * run
    return ak


def fourier_f_pdf(tab: FourierTable, wo, wi):
    """FourierBSDF::f and ::Pdf for local directions. Returns (f (R, 3),
    pdf (R,)); the pdf is the two-sided cosine sampler's (not pbrt's
    SampleFourier pdf)."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    cos_phi = _cos_dphi(-wi, wo)
    ak = _blend_coeffs(tab, mu_i, mu_o)
    mmax = tab.m_max
    y = torch.clamp(fourier(ak[..., 0, :], cos_phi, mmax), min=0.0)
    zero = torch.zeros_like(mu_i)
    scale = torch.where(torch.abs(mu_i) > 1e-6, 1.0 / torch.clamp(torch.abs(mu_i), min=1e-6),
                        zero)
    # radiance transport: a transmission scales by 1/eta^2 of its side
    trans = mu_i * mu_o > 0.0  # pbrt's muI = cos(-wi): the same sign transmits
    # 1 / eta in f64 on the host, then f32 (the reference's Python constants)
    eta_d = torch.where(mu_i > 0.0, torch.full_like(mu_i, 1.0 / tab.eta),
                        torch.full_like(mu_i, tab.eta))
    scale = scale * torch.where(trans, eta_d * eta_d, torch.ones_like(eta_d))
    if tab.n_channels == 1:
        f = torch.stack([y, y, y], dim=-1) * scale[..., None]
    else:
        r = fourier(ak[..., 1, :], cos_phi, mmax)
        b = fourier(ak[..., 2, :], cos_phi, mmax)
        g = 1.39829 * y - 0.100913 * b - 0.297375 * r
        f = torch.stack([r, g, b], dim=-1) * scale[..., None]
    f = torch.clamp(f, min=0.0)
    # |cos| / pi split across the two hemispheres
    pdf = torch.abs(wi[..., 2]) / torch.full_like(mu_i, float(np.float32(np.pi))) * 0.5
    return f, pdf


def fourier_sample_wi(wo, u_lobe, u1, u2):
    """The two-sided cosine draw: a cosine-hemisphere direction, flipped
    to the lower hemisphere when u_lobe < 1/2 (independent of wo's side)."""
    wi = cosine_sample_hemisphere(u1, u2)
    flip = u_lobe < 0.5
    down = wi * torch.tensor([1.0, 1.0, -1.0], dtype=wi.dtype, device=wi.device)
    return torch.where(flip[..., None], down, wi)
