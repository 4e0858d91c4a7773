"""Film: filter-weighted sample accumulation (port of tpu_pbrt/core/film.py).

The film state is three tensors (rgb, weight, splat) on the render
device; a batch of samples lands by scatter-adds. Unlike the reference's
functional updates, the deposits here add into the state IN PLACE (the
state is the render's own accumulator, and an (H, W, 3) copy per chunk
buys nothing).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pbrt_torch.core.filters import FilterSpec
from tpu_pbrt_torch.core.spectrum import luminance
from tpu_pbrt_torch.utils.error import Error, Warning


class FilmState(NamedTuple):
    rgb: torch.Tensor  # (H, W, 3) filter-weighted radiance sums
    weight: torch.Tensor  # (H, W) filter weight sums
    splat: torch.Tensor  # (H, W, 3) unweighted splats


def nonfinite_mask(L) -> torch.Tensor:
    """Rows of a (..., 3) radiance batch carrying any NaN/Inf component."""
    return (~torch.isfinite(L)).any(dim=-1)


def merge_film(a: FilmState, b: FilmState) -> FilmState:
    """Sum two film accumulators (film accumulation is associative: the
    per-device contributions of a split render merge this way)."""
    return FilmState(a.rgb + b.rgb, a.weight + b.weight, a.splat + b.splat)


class Film:
    def __init__(
        self,
        resolution=(1280, 720),
        crop_window=(0.0, 1.0, 0.0, 1.0),
        filt: Optional[FilterSpec] = None,
        diagonal_mm: float = 35.0,
        filename: str = "pbrt.exr",
        scale: float = 1.0,
        max_sample_luminance: float = float("inf"),
    ):
        self.full_resolution = (int(resolution[0]), int(resolution[1]))
        self.filter = filt or FilterSpec("box", 0.5, 0.5, 0.0, 0.0)
        self.diagonal = diagonal_mm * 0.001
        self.filename = filename
        self.scale = scale
        self.max_sample_luminance = max_sample_luminance
        x0, x1, y0, y1 = crop_window
        rx, ry = self.full_resolution
        self.cropped_pixel_bounds = (
            int(math.ceil(rx * x0)),
            int(math.ceil(rx * x1)),
            int(math.ceil(ry * y0)),
            int(math.ceil(ry * y1)),
        )
        if (
            self.cropped_pixel_bounds[1] <= self.cropped_pixel_bounds[0]
            or self.cropped_pixel_bounds[3] <= self.cropped_pixel_bounds[2]
        ):
            Error("Degenerate crop window")

    def sample_bounds(self):
        """Film::GetSampleBounds."""
        fx, fy = self.filter.xwidth, self.filter.ywidth
        x0, x1, y0, y1 = self.cropped_pixel_bounds
        return (
            int(math.floor(x0 + 0.5 - fx)),
            int(math.ceil(x1 - 0.5 + fx)),
            int(math.floor(y0 + 0.5 - fy)),
            int(math.ceil(y1 - 0.5 + fy)),
        )

    def physical_extent(self):
        """Film::GetPhysicalExtent (meters): the film's (x0, x1, y0, y1)
        from its diagonal and aspect."""
        rx, ry = self.full_resolution
        aspect = ry / rx
        x = math.sqrt(self.diagonal * self.diagonal / (1 + aspect * aspect))
        y = aspect * x
        return (-x / 2, x / 2, -y / 2, y / 2)

    def init_state(self, device="cpu") -> FilmState:
        rx, ry = self.full_resolution
        return FilmState(
            rgb=torch.zeros((ry, rx, 3), dtype=torch.float32, device=device),
            weight=torch.zeros((ry, rx), dtype=torch.float32, device=device),
            splat=torch.zeros((ry, rx, 3), dtype=torch.float32, device=device),
        )

    def _prep(self, L, ray_weight):
        """pbrt AddSample's radiance clean-up: zero NaN/Inf rows, clamp to
        maxsampleluminance, apply the camera ray weight."""
        L = L.to(torch.float32)
        L = torch.where(nonfinite_mask(L)[..., None], torch.zeros_like(L), L)
        if np.isfinite(self.max_sample_luminance):
            y = luminance(L)
            s = torch.where(
                y > self.max_sample_luminance,
                self.max_sample_luminance / torch.clamp(y, min=1e-20),
                torch.ones_like(y),
            )
            L = L * s[..., None]
        if ray_weight is not None:
            L = L * ray_weight.to(torch.float32)[..., None]
        return L

    def add_samples(self, state: FilmState, p_film, L, ray_weight=None) -> FilmState:
        """FilmTile::AddSample over a batch. p_film: (R,2) raster coords,
        L: (R,3). The filter's (nx x ny) footprint taps are deposited as
        ONE scatter-add of the taps inside the crop window with a nonzero
        weight (one host read for their count). The reference scatters
        tap by tap and clamps masked lanes and off-crop taps onto the
        frame's edges with weight 0; the deterministic scatter-add
        serializes the entries that share a pixel, so those zeros would
        pile up there. Adding a zero changes no sum, and the entries keep
        the reference's order (tap by tap, lanes in order), which the
        deterministic scatter-add keeps per pixel: the sums are the
        reference's bit for bit."""
        f = self.filter
        L = self._prep(L, ray_weight)
        dx = p_film[..., 0] - 0.5
        dy = p_film[..., 1] - 0.5
        x0f = torch.ceil(dx - f.xwidth)
        y0f = torch.ceil(dy - f.ywidth)
        nx = int(math.floor(2 * f.xwidth)) + 1
        ny = int(math.floor(2 * f.ywidth)) + 1
        # tap-major (ny*nx, R) offsets, in the reference's loop order
        oy, ox = torch.meshgrid(torch.arange(ny, device=L.device), torch.arange(nx, device=L.device),
                                indexing="ij")
        oxf = ox.reshape(-1, 1).to(torch.float32)
        oyf = oy.reshape(-1, 1).to(torch.float32)
        tx = x0f + oxf
        ty = y0f + oyf
        fw = f.evaluate(tx - dx, ty - dy)
        cx0, cx1, cy0, cy1 = self.cropped_pixel_bounds
        keep = (tx >= cx0) & (tx < cx1) & (ty >= cy0) & (ty < cy1) & (fw != 0.0)
        sel = torch.nonzero(keep.reshape(-1), as_tuple=True)[0]
        rx = self.full_resolution[0]
        pix = ty.reshape(-1)[sel].to(torch.int64) * rx + tx.reshape(-1)[sel].to(torch.int64)
        w = fw.reshape(-1)[sel]
        lane = sel % L.shape[0]
        state.rgb.view(-1, 3).index_put_((pix,), w[:, None] * L[lane], accumulate=True)
        state.weight.view(-1).index_put_((pix,), w, accumulate=True)
        return state

    def aligned_chunk_pixels(self, chunk: int, spp: int) -> int:
        """Gate for add_samples_aligned: the pixels per chunk when the
        fast path applies (box(0.5) filter, full-frame crop, whole-pixel
        chunks tiling the frame exactly), else 0."""
        rx, ry = self.full_resolution
        if not self.pixel_deposit_ok() or spp <= 0 or chunk % spp:
            return 0
        npc = chunk // spp
        return npc if (rx * ry) % npc == 0 else 0

    def add_samples_aligned(self, state: FilmState, start_pix: int, spp: int, L,
                            ray_weight=None) -> FilmState:
        """add_samples for a chunk of `chunk // spp` consecutive pixels
        with spp consecutive samples each (the render loop's layout): the
        per-pixel sums are one reshape + sum and the film update two
        contiguous slice-adds, no scatter. The caller must have checked
        aligned_chunk_pixels() != 0. Shares add_samples_pixel's deviation
        for a jitter of exactly 0.0 (own pixel only)."""
        L = self._prep(L, ray_weight)
        npc = L.shape[0] // spp
        rx, ry = self.full_resolution
        rgb = state.rgb.view(rx * ry, 3)
        rgb[start_pix:start_pix + npc] += L.reshape(npc, spp, 3).sum(dim=1)
        state.weight.view(rx * ry)[start_pix:start_pix + npc] += float(spp)
        return state

    def pixel_deposit_ok(self) -> bool:
        """Gate for add_samples_pixel: box(0.5) filter over the full frame."""
        f = self.filter
        rx, ry = self.full_resolution
        return (
            f.name == "box" and f.xwidth == 0.5 and f.ywidth == 0.5
            and self.cropped_pixel_bounds == (0, rx, 0, ry)
        )

    def add_samples_pixel(self, state: FilmState, px, py, L, mask,
                          ray_weight=None) -> FilmState:
        """add_samples for the box(0.5)/full-frame case with known integer
        pixel coordinates: each masked sample deposits into its own pixel
        with weight 1 (a jitter of exactly 0.0 deposits into its own pixel
        only, as the reference's aligned and pixel deposits do)."""
        L = self._prep(L, ray_weight)
        rx, ryres = self.full_resolution
        pxc = px.long().clamp(0, rx - 1)
        pyc = py.long().clamp(0, ryres - 1)
        state.rgb.index_put_(
            (pyc, pxc), torch.where(mask[..., None], L, torch.zeros_like(L)), accumulate=True
        )
        state.weight.index_put_(
            (pyc, pxc), mask.to(torch.float32), accumulate=True
        )
        return state

    def add_splats(self, state: FilmState, p_film, v) -> FilmState:
        """Film::AddSplat over a batch: no filter, the value lands in the
        pixel under p_film (box deposit) after AddSample's clean-up
        (non-finite rows zeroed, maxsampleluminance clamp); splats outside
        the crop window are dropped."""
        v = self._prep(v, None)
        px = torch.floor(p_film[..., 0])
        py = torch.floor(p_film[..., 1])
        # f32 -> int saturates like XLA's convert (NaN -> 0)
        px = torch.nan_to_num(px, nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)
        py = torch.nan_to_num(py, nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)
        cx0, cx1, cy0, cy1 = self.cropped_pixel_bounds
        inb = (px >= cx0) & (px < cx1) & (py >= cy0) & (py < cy1)
        # only nonzero splats inside the crop land: adding a zero changes no
        # sum, and the deterministic scatter-add serializes the zeros of
        # rejected strategies piled on one pixel (one host read for the count)
        keep = torch.nonzero(inb & (v != 0.0).any(dim=-1), as_tuple=True)
        state.splat.index_put_((py[keep], px[keep]), v[keep], accumulate=True)
        return state

    def develop(self, state: FilmState, splat_scale: float = 1.0) -> np.ndarray:
        """Film::WriteImage math: rgb/filterWeightSum + splatScale*splat,
        then `scale`. Returns the cropped (h, w, 3) float32 image."""
        rgb = state.rgb.detach().cpu().numpy().astype(np.float64)
        w = state.weight.detach().cpu().numpy().astype(np.float64)
        splat = state.splat.detach().cpu().numpy().astype(np.float64)
        img = rgb / np.maximum(w, 1e-20)[..., None]
        img = np.where(w[..., None] > 0, img, 0.0)
        img = img + splat_scale * splat
        img = img * self.scale
        x0, x1, y0, y1 = self.cropped_pixel_bounds
        return img[y0:y1, x0:x1].astype(np.float32)

    def write_image(self, state: FilmState, splat_scale: float = 1.0, filename: str = ""):
        """Film::WriteImage: develop and write to `filename` (default: the
        film's), the format chosen by the extension (utils/imageio.py)."""
        from tpu_pbrt_torch.utils import imageio

        img = self.develop(state, splat_scale)
        imageio.write_image(filename or self.filename, img)
        return img


def make_film(name: str, params, filt: FilterSpec, options=None) -> Film:
    """api.cpp MakeFilm -> CreateFilm."""
    if name != "image":
        Warning(f'Film "{name}" unknown; using "image".')
    xres = params.find_one_int("xresolution", 1280)
    yres = params.find_one_int("yresolution", 720)
    if options is not None and getattr(options, "quick_render", False):
        xres = max(1, xres // 4)
        yres = max(1, yres // 4)
    crop = (0.0, 1.0, 0.0, 1.0)
    cr = params.find_float("cropwindow")
    if cr is not None and len(cr) == 4:
        crop = (
            min(cr[0], cr[1]), max(cr[0], cr[1]),
            min(cr[2], cr[3]), max(cr[2], cr[3]),
        )
    elif cr is not None:
        Error(f"{len(cr)} values supplied for \"cropwindow\". Expected 4.")
    if options is not None and getattr(options, "crop_window", None):
        c = options.crop_window
        crop = (c[0], c[1], c[2], c[3])
    filename = params.find_one_string("filename", "")
    if options is not None and getattr(options, "image_file", ""):
        filename = options.image_file
    if not filename:
        filename = "pbrt.exr"
    return Film(
        resolution=(xres, yres),
        crop_window=crop,
        filt=filt,
        diagonal_mm=params.find_one_float("diagonal", 35.0),
        filename=filename,
        scale=params.find_one_float("scale", 1.0),
        max_sample_luminance=params.find_one_float("maxsampleluminance", float("inf")),
    )

