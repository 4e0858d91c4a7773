"""Color/spectrum handling.

Capability match for pbrt-v3 src/core/spectrum.{h,cpp}. The device color
representation is linear RGB float32 (pbrt's default RGBSpectrum; its
compile-time SampledSpectrum<60> variant is subsumed by host-side spectral
conversion: arbitrary SPDs, XYZ and blackbody inputs are integrated against
CIE matching curves at scene-compile time, which is where pbrt itself
converts for RGB rendering).

CIE matching functions use the Wyman–Sloan–Shirley multi-lobe Gaussian fits
(JCGT 2013) — within ~1% of the tabulated CIE 1931 curves, which is well
inside rendering tolerance and keeps tables out of the repo.
"""

from __future__ import annotations

import numpy as np

# sRGB/Rec709 primaries, D65 white (matches pbrt's RGB<->XYZ matrices)
_XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)

CIE_Y_INTEGRAL = 106.856895


def xyz_to_rgb(xyz) -> np.ndarray:
    return _XYZ_TO_RGB @ np.asarray(xyz, dtype=np.float64)


def rgb_to_xyz(rgb) -> np.ndarray:
    return _RGB_TO_XYZ @ np.asarray(rgb, dtype=np.float64)


def luminance(rgb):
    """Rec.709 luminance (pbrt RGBSpectrum::y). Backend-agnostic: works on
    numpy arrays and torch tensors; returns an array of rgb's batch shape.
    A tensor's sum of products is contracted as the reference's compiled
    program contracts it, fma(b, c2, fma(r, c0, c1 g)); a numpy array's
    is the reference's host arithmetic."""
    if isinstance(rgb, np.ndarray):
        return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    from tpu_pbrt_torch.core.xla_math import fmac

    return fmac(rgb[..., 2], 0.072169, fmac(rgb[..., 0], 0.212671, 0.715160 * rgb[..., 1]))


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-((x - mu) ** 2) / (2 * s * s))


def cie_x(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return _gauss(lam, 1.056, 599.8, 37.9, 31.0) + _gauss(lam, 0.362, 442.0, 16.0, 26.7) + _gauss(
        lam, -0.065, 501.1, 20.4, 26.2
    )


def cie_y(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)


def cie_z(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)


def spd_to_xyz(lam: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Integrate a piecewise-linear SPD (sorted by wavelength, nm) against the
    CIE curves (pbrt SampledSpectrum::FromSampled -> ToXYZ)."""
    order = np.argsort(lam)
    lam, vals = np.asarray(lam, dtype=np.float64)[order], np.asarray(vals, dtype=np.float64)[order]
    grid = np.arange(360.0, 831.0, 1.0)
    v = np.interp(grid, lam, vals, left=vals[0], right=vals[-1])
    x = np.trapezoid(v * cie_x(grid), grid)
    y = np.trapezoid(v * cie_y(grid), grid)
    z = np.trapezoid(v * cie_z(grid), grid)
    return np.array([x, y, z]) / CIE_Y_INTEGRAL


def spd_to_rgb(lam: np.ndarray, vals: np.ndarray) -> np.ndarray:
    return xyz_to_rgb(spd_to_xyz(lam, vals))


def blackbody(lam_nm: np.ndarray, t_kelvin: float) -> np.ndarray:
    """Planck's law, spectral radiance (pbrt Blackbody, W/(m^2 sr m))."""
    lam = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    return (2 * h * c * c) / (lam**5 * (np.expm1(h * c / (lam * kb * t_kelvin))))


def blackbody_rgb_normalized(t_kelvin: float) -> np.ndarray:
    """pbrt BlackbodyNormalized: scaled so peak wavelength has value 1, then
    converted to RGB."""
    grid = np.arange(360.0, 831.0, 1.0)
    le = blackbody(grid, t_kelvin)
    lam_max = 2.8977721e-3 / t_kelvin * 1e9
    max_l = blackbody(np.array([lam_max]), t_kelvin)[0]
    return spd_to_rgb(grid, le / max_l)


# Named metal spectra (pbrt ships .spd files for these under
# scenes' spds/ and embeds Cu/CuK as the MetalMaterial default).
# RGB values below were produced by integrating the tabulated
# refractiveindex.info data against the CIE fits above.
NAMED_SPECTRA_RGB = {
    "metal-cu-eta": np.array([0.2004, 0.9240, 1.1022]),
    "metal-cu-k": np.array([3.9129, 2.4528, 2.1421]),
    "metal-au-eta": np.array([0.1431, 0.3749, 1.4424]),
    "metal-au-k": np.array([3.9831, 2.3857, 1.6032]),
    "metal-ag-eta": np.array([0.1553, 0.1163, 0.1380]),
    "metal-ag-k": np.array([4.8283, 3.1222, 2.1469]),
    "metal-al-eta": np.array([1.3456, 0.9654, 0.6172]),
    "metal-al-k": np.array([7.4746, 6.3995, 5.3031]),
    "glass-bk7": np.array([1.5131, 1.5191, 1.5253]),
}
