"""Image I/O: EXR, PFM, PNG, TGA, HDR(RGBE) — self-contained codecs.

A copy of tpu_pbrt/utils/imageio.py (numpy only), kept in the port so it
imports nothing of the JAX package.

Capability match for pbrt-v3 src/core/imageio.{h,cpp} (ReadImage/WriteImage
dispatch by extension) and the src/ext/ libraries backing it (OpenEXR,
lodepng, targa). The build environment has no OpenEXR/PIL, so the codecs
are implemented directly: EXR scanline (NONE/ZIPS/ZIP compression, HALF and
FLOAT channels), PNG (zlib + the five scanline filters, 8/16-bit,
gray/RGB/alpha/palette), TGA (types 2/10, 24/32bpp), Radiance RGBE, PFM.

Convention matches pbrt: ReadImage returns linear RGB float32 (H,W,3) with
8-bit LDR formats inverse-gamma'd from sRGB; WriteImage takes linear RGB and
gamma-encodes when writing LDR formats.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from tpu_pbrt_torch.utils.error import Error, Warning


# -------------------------------------------------------------------------
# sRGB transfer (pbrt GammaCorrect / InverseGammaCorrect)
# -------------------------------------------------------------------------

def gamma_correct(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, 12.92 * v, 1.055 * np.power(v, 1.0 / 2.4) - 0.055)


def inverse_gamma_correct(v):
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


# -------------------------------------------------------------------------
# EXR
# -------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def _exr_attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0" + struct.pack("<i", len(data)) + data
    )


def write_exr(path: str, img: np.ndarray, half: bool = True):
    """Scanline EXR, ZIP-compressed blocks of 16, channels B,G,R."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    pt = _PT_HALF if half else _PT_FLOAT
    psz = 2 if half else 4
    chans = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, as required
        chans += name + b"\0" + struct.pack("<iiii", pt, 0, 1, 1)
    chans += b"\0"
    header = b""
    header += _exr_attr("channels", "chlist", chans)
    header += _exr_attr("compression", "compression", struct.pack("<B", 3))  # ZIP
    header += _exr_attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    dtype = np.float16 if half else np.float32
    n_blocks = (h + 15) // 16
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * 16
        rows = min(16, h - y0)
        raw = bytearray()
        for y in range(y0, y0 + rows):
            for c in (2, 1, 0):  # B, G, R
                raw += img[y, :, c].astype(dtype).tobytes()
        raw = bytes(raw)
        # EXR zip preprocess: interleave-split then delta encode
        a = np.frombuffer(raw, np.uint8)
        half_len = (len(a) + 1) // 2
        inter = np.empty_like(a)
        inter[:half_len] = a[0::2]
        inter[half_len:] = a[1::2]
        d = inter.astype(np.int16)
        d[1:] = d[1:] - d[:-1] + (-128 + 256)
        enc = (d & 0xFF).astype(np.uint8).tobytes()
        comp = zlib.compress(enc, 6)
        if len(comp) >= len(raw):
            comp = raw  # stored uncompressed when bigger (per spec)
        blocks.append((y0, comp))

    out = bytearray()
    out += struct.pack("<ii", _EXR_MAGIC, 2)
    out += header
    offset_table_pos = len(out)
    out += b"\0" * (8 * n_blocks)
    offsets = []
    for y0, comp in blocks:
        offsets.append(len(out))
        out += struct.pack("<ii", y0, len(comp)) + comp
    for i, off in enumerate(offsets):
        struct.pack_into("<Q", out, offset_table_pos + 8 * i, off)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _exr_unpredict(data: bytes) -> bytes:
    d = np.frombuffer(data, np.uint8).astype(np.int16)
    d[1:] += -128
    d = np.cumsum(d, dtype=np.int64) % 256  # delta decode
    d = d.astype(np.uint8)
    # de-interleave: first half -> even positions
    out = np.empty_like(d)
    half_len = (len(d) + 1) // 2
    out[0::2] = d[:half_len]
    out[1::2] = d[half_len:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        Error(f"{path}: not an EXR file")
    if version & 0x200:
        Error(f"{path}: tiled EXR not supported")
    pos = 8
    channels = []
    compression = 0
    dw = (0, 0, 0, 0)
    while True:
        if data[pos] == 0:
            pos += 1
            break
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        tname = data[pos:e].decode()
        pos = e + 1
        (sz,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos : pos + sz]
        pos += sz
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\0", cp)
                cname = payload[cp:ce].decode()
                cp = ce + 1
                ptype, _, xs, ys = struct.unpack_from("<iiii", payload, cp)
                cp += 16
                channels.append((cname, ptype, xs, ys))
            if any(c[2] != 1 or c[3] != 1 for c in channels):
                Error(f"{path}: subsampled channels not supported")
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    if compression not in (0, 2, 3):
        Error(f"{path}: EXR compression mode {compression} not supported (use none/zip)")
    rows_per_block = {0: 1, 2: 1, 3: 16}[compression]
    n_blocks = (h + rows_per_block - 1) // rows_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
    dtypes = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
    bpp = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
    row_bytes = sum(bpp[c[1]] for c in channels) * w
    planes = {c[0]: np.zeros((h, w), np.float32) for c in channels}
    for off in offsets:
        y, sz = struct.unpack_from("<ii", data, off)
        y -= dw[1]
        payload = data[off + 8 : off + 8 + sz]
        rows = min(rows_per_block, h - y)
        expect = row_bytes * rows
        if compression and sz != expect:
            payload = _exr_unpredict(zlib.decompress(payload))
        p = 0
        for r in range(rows):
            for cname, ptype, _, _ in channels:  # alphabetical within a row
                n = bpp[ptype] * w
                vals = np.frombuffer(payload[p : p + n], dtypes[ptype]).astype(np.float32)
                planes[cname][y + r] = vals
                p += n
    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if "Y" in planes:
        return planes["Y"][..., None].repeat(3, axis=-1)
    first = next(iter(planes.values()))
    return first[..., None].repeat(3, axis=-1)


# -------------------------------------------------------------------------
# PFM
# -------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray):
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    color = img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # little-endian
        f.write(img[::-1].astype("<f4").tobytes())  # bottom-up rows


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        dims = f.readline().split()
        scale = float(f.readline())
        w, h = int(dims[0]), int(dims[1])
        nc = 3 if kind == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        a = np.frombuffer(f.read(4 * w * h * nc), dt).reshape(h, w, nc)[::-1]
    a = a.astype(np.float32) * abs(scale)
    return a.repeat(3, axis=-1) if nc == 1 else a.copy()


# -------------------------------------------------------------------------
# PNG
# -------------------------------------------------------------------------

def write_png(path: str, img8: np.ndarray):
    """img8: (H,W,3) uint8."""
    h, w = img8.shape[:2]
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        c = tag + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _png_unfilter(raw: np.ndarray, h: int, stride: int, fpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        pos += 1
        row = raw[pos : pos + stride].astype(np.int32)
        pos += stride
        if ft == 0:
            cur = row
        elif ft == 1:  # sub
            cur = row.copy()
            for i in range(fpp, stride):
                cur[i] = (cur[i] + cur[i - fpp]) & 0xFF
        elif ft == 2:  # up
            cur = (row + prev) & 0xFF
        elif ft == 3:  # average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - fpp] if i >= fpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            cur = row.copy()
            for i in range(stride):
                a = cur[i - fpp] if i >= fpp else 0
                b = prev[i]
                c = prev[i - fpp] if i >= fpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            Error(f"PNG: bad filter type {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Returns linear RGB float32 (inverse sRGB applied to 8/16-bit data)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        Error(f"{path}: not a PNG")
    pos = 8
    idat = b""
    plte = None
    w = h = depth = ctype = interlace = 0
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if interlace:
        Error(f"{path}: interlaced PNG not supported")
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bypp = max(1, depth // 8) * nchan
    stride = (w * depth * nchan + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = _png_unfilter(raw, h, stride, bypp)
    if depth == 8:
        px = rows.reshape(h, stride)[:, : w * nchan].reshape(h, w, nchan).astype(np.float32) / 255.0
    elif depth == 16:
        px = rows.reshape(h, -1).view(">u2")[:, : w * nchan].reshape(h, w, nchan).astype(np.float32) / 65535.0
    elif depth in (1, 2, 4) and ctype in (0, 3):
        # unpack sub-byte samples
        bits = np.unpackbits(rows, axis=1)
        spb = depth
        vals = np.zeros((h, w), np.int32)
        for b in range(spb):
            vals = (vals << 1) | bits[:, b::spb][:, :w]
        px = (vals.astype(np.float32) / ((1 << depth) - 1))[..., None]
    else:
        Error(f"{path}: unsupported PNG depth {depth}")
    if ctype == 3:
        idx = (px[..., 0] * 255 if depth == 8 else px[..., 0] * ((1 << depth) - 1)).astype(np.int32)
        px = plte[idx].astype(np.float32) / 255.0
    if px.shape[2] == 1:
        px = px.repeat(3, axis=-1)
    elif px.shape[2] == 2:
        px = px[..., :1].repeat(3, axis=-1)
    elif px.shape[2] == 4:
        px = px[..., :3]
    return inverse_gamma_correct(px).astype(np.float32)


# -------------------------------------------------------------------------
# TGA
# -------------------------------------------------------------------------

def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp = data[16]
    desc = data[17]
    pos = 18 + idlen + (struct.unpack_from("<H", data, 5)[0] * ((data[7] + 7) // 8) if cmap_type else 0)
    nb = bpp // 8
    if img_type in (2, 3):
        px = np.frombuffer(data, np.uint8, w * h * nb, pos).reshape(h, w, nb)
    elif img_type in (10, 11):
        out = np.zeros((h * w, nb), np.uint8)
        i = 0
        while i < h * w:
            hdr = data[pos]
            pos += 1
            cnt = (hdr & 0x7F) + 1
            if hdr & 0x80:
                out[i : i + cnt] = np.frombuffer(data, np.uint8, nb, pos)
                pos += nb
            else:
                out[i : i + cnt] = np.frombuffer(data, np.uint8, cnt * nb, pos).reshape(cnt, nb)
                pos += cnt * nb
            i += cnt
        px = out.reshape(h, w, nb)
    else:
        Error(f"{path}: TGA type {img_type} not supported")
    if not (desc & 0x20):  # bottom-up origin
        px = px[::-1]
    if nb >= 3:
        px = px[..., [2, 1, 0]]  # BGR -> RGB
    else:
        px = px[..., :1].repeat(3, axis=-1)
    return inverse_gamma_correct(px.astype(np.float32) / 255.0).astype(np.float32)


# -------------------------------------------------------------------------
# Radiance HDR (RGBE)
# -------------------------------------------------------------------------

def read_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:
        e = data.index(b"\n", pos)
        line = data[pos:e]
        pos = e + 1
        if line == b"":
            break
    e = data.index(b"\n", pos)
    dims = data[pos:e].split()
    pos = e + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        Error(f"{path}: unsupported HDR orientation")
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if w >= 8 and w < 32768 and data[pos] == 2 and data[pos + 1] == 2:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x : x + cnt, c] = np.frombuffer(data, np.uint8, cnt, pos)
                        pos += cnt
                        x += cnt
        else:
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32) - 128 - 8
    scale = np.ldexp(1.0, exp).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


# -------------------------------------------------------------------------
# dispatch (pbrt ReadImage / WriteImage)
# -------------------------------------------------------------------------

def read_image(path: str, gamma: bool = None) -> np.ndarray:
    """-> linear RGB float32 (H,W,3)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".png":
        return read_png(path)
    if ext == ".tga":
        return read_tga(path)
    if ext == ".hdr":
        return read_hdr(path)
    Error(f'unable to load image stored in format "{ext}" for filename "{path}"')


def write_image(path: str, img: np.ndarray):
    """img: linear RGB float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return write_exr(path, img)
    if ext == ".pfm":
        return write_pfm(path, img)
    if ext in (".png", ""):
        img8 = (gamma_correct(np.asarray(img)) * 255.0 + 0.5).astype(np.uint8)
        return write_png(path if ext else path + ".png", img8)
    if ext == ".tga":
        img8 = (gamma_correct(np.asarray(img)) * 255.0 + 0.5).astype(np.uint8)
        h, w = img8.shape[:2]
        with open(path, "wb") as f:
            f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20))
            f.write(img8[..., [2, 1, 0]].tobytes())
        return
    Warning(f'format of "{path}" unknown; writing PNG')
    img8 = (gamma_correct(np.asarray(img)) * 255.0 + 0.5).astype(np.uint8)
    write_png(path + ".png", img8)
