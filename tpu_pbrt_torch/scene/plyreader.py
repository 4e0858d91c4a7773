"""PLY mesh reader (ascii + binary little/big endian).

Capability match for pbrt-v3's src/ext/rply + shapes/plymesh.cpp
CreatePLYMesh: reads vertex positions, normals, uvs (u,v / s,t /
texture_u,texture_v aliases) and face indices (triangulating polygon fans),
returning numpy arrays for the TriangleMesh compiler.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_pbrt_torch.utils.error import Error, Warning

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def read_ply(path: str) -> Dict[str, Optional[np.ndarray]]:
    """Returns dict with 'vertices' (V,3) f64, 'indices' (T,3) i64, and
    optional 'normals' (V,3), 'uvs' (V,2), 'face_indices' (per-face int)."""
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        Error(f"{path}: not a PLY file")
    end = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    body = data[end:]

    fmt = None
    elements: List[Tuple[str, int, list]] = []  # (name, count, [(prop, type, list_count_type|None)])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                continue
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    if fmt is None:
        Error(f"{path}: PLY missing format line")

    out: Dict[str, Optional[np.ndarray]] = {"vertices": None, "indices": None, "normals": None, "uvs": None, "face_indices": None}

    if fmt == "ascii":
        _read_ascii(body, elements, out, path)
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        _read_binary(body, elements, out, path, endian)

    if out["vertices"] is None or out["indices"] is None:
        Error(f"{path}: PLY file missing vertices or faces")
    return out


def _collect_vertex(props: list, rows: np.ndarray, out, path):
    names = [p[0] for p in props]

    def col(*cands):
        for c in cands:
            if c in names:
                return rows[:, names.index(c)]
        return None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        Error(f"{path}: PLY vertex element missing x/y/z")
    out["vertices"] = np.stack([x, y, z], axis=1).astype(np.float64)
    nx, ny, nz = col("nx"), col("ny"), col("nz")
    if nx is not None and ny is not None and nz is not None:
        out["normals"] = np.stack([nx, ny, nz], axis=1).astype(np.float64)
    u = col("u", "s", "texture_u", "texture_s")
    v = col("v", "t", "texture_v", "texture_t")
    if u is not None and v is not None:
        out["uvs"] = np.stack([u, v], axis=1).astype(np.float64)


def _triangulate(faces: List[List[int]], face_idx_vals: Optional[List[int]], out):
    tris = []
    fidx = []
    for i, fc in enumerate(faces):
        if len(fc) < 3:
            continue
        for k in range(1, len(fc) - 1):  # fan triangulation (rply/pbrt behavior)
            tris.append((fc[0], fc[k], fc[k + 1]))
            if face_idx_vals is not None:
                fidx.append(face_idx_vals[i])
    out["indices"] = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    if face_idx_vals is not None:
        out["face_indices"] = np.asarray(fidx, dtype=np.int64)


def _read_ascii(body: bytes, elements, out, path):
    toks = body.decode("ascii", errors="replace").split()
    pos = 0

    def take(n):
        nonlocal pos
        v = toks[pos : pos + n]
        pos += n
        return v

    for name, count, props in elements:
        if name == "vertex":
            rows = np.empty((count, len(props)), dtype=np.float64)
            for i in range(count):
                vals = []
                for pname, ptype, list_ct in props:
                    if list_ct is None:
                        vals.append(float(take(1)[0]))
                    else:
                        n = int(float(take(1)[0]))
                        take(n)
                        vals.append(0.0)
                rows[i] = vals
            _collect_vertex(props, rows, out, path)
        elif name == "face":
            faces = []
            fvals: List[int] = []
            has_fi = any(p[0] == "face_indices" for p in props)
            for i in range(count):
                fc = None
                fi = 0
                for pname, ptype, list_ct in props:
                    if list_ct is not None:
                        n = int(float(take(1)[0]))
                        idx = [int(float(t)) for t in take(n)]
                        if pname in ("vertex_indices", "vertex_index"):
                            fc = idx
                    else:
                        v = float(take(1)[0])
                        if pname == "face_indices":
                            fi = int(v)
                if fc is not None:
                    faces.append(fc)
                    fvals.append(fi)
            _triangulate(faces, fvals if has_fi else None, out)
        else:
            for i in range(count):  # skip unknown elements
                for pname, ptype, list_ct in props:
                    if list_ct is None:
                        take(1)
                    else:
                        n = int(float(take(1)[0]))
                        take(n)


def _read_binary(body: bytes, elements, out, path, endian):
    off = 0
    for name, count, props in elements:
        all_scalar = all(p[2] is None for p in props)
        if name == "vertex":
            if all_scalar:
                # fast path: fixed-stride struct
                dtype = np.dtype([(p[0], endian + _PLY_TYPES[p[1]][0]) for p in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
                off += dtype.itemsize * count
                rows = np.stack([arr[p[0]].astype(np.float64) for p in props], axis=1)
                _collect_vertex(props, rows, out, path)
            else:
                # slow path: vertex element carrying list properties
                rows = np.empty((count, len(props)), dtype=np.float64)
                for i in range(count):
                    for j, (pname, ptype, ct_type) in enumerate(props):
                        if ct_type is None:
                            it_fmt, it_sz = _PLY_TYPES[ptype]
                            rows[i, j] = np.frombuffer(body, dtype=endian + it_fmt, count=1, offset=off)[0]
                            off += it_sz
                        else:
                            ct_fmt, ct_sz = _PLY_TYPES[ct_type]
                            n = int(np.frombuffer(body, dtype=endian + ct_fmt, count=1, offset=off)[0])
                            off += ct_sz + n * _PLY_TYPES[ptype][1]
                            rows[i, j] = 0.0
                _collect_vertex(props, rows, out, path)
        elif name == "face":
            faces = []
            fvals: List[int] = []
            has_fi = any(p[0] == "face_indices" for p in props)
            # fast path: single list property with uniform arity 3
            if len(props) == 1 and props[0][2] is not None:
                pname, ptype, ct_type = props[0]
                ct_fmt, ct_sz = _PLY_TYPES[ct_type]
                it_fmt, it_sz = _PLY_TYPES[ptype]
                first_n = int(np.frombuffer(body, dtype=endian + ct_fmt, count=1, offset=off)[0])
                stride = ct_sz + first_n * it_sz
                if count * stride <= len(body) - off:
                    raw = np.frombuffer(body, dtype=np.uint8, count=count * stride, offset=off)
                    counts = raw.reshape(count, stride)[:, :ct_sz].copy().view(endian + ct_fmt).ravel()
                    if np.all(counts == first_n):
                        idx = (
                            raw.reshape(count, stride)[:, ct_sz:]
                            .copy()
                            .view(endian + it_fmt)
                            .reshape(count, first_n)
                            .astype(np.int64)
                        )
                        off += count * stride
                        if first_n == 3:
                            out["indices"] = idx
                        else:
                            _triangulate([list(r) for r in idx], None, out)
                        continue
            # slow path: per-face parse
            for i in range(count):
                fc = None
                fi = 0
                for pname, ptype, ct_type in props:
                    if ct_type is not None:
                        ct_fmt, ct_sz = _PLY_TYPES[ct_type]
                        n = int(np.frombuffer(body, dtype=endian + ct_fmt, count=1, offset=off)[0])
                        off += ct_sz
                        it_fmt, it_sz = _PLY_TYPES[ptype]
                        idx = np.frombuffer(body, dtype=endian + it_fmt, count=n, offset=off).astype(np.int64)
                        off += n * it_sz
                        if pname in ("vertex_indices", "vertex_index"):
                            fc = list(idx)
                    else:
                        it_fmt, it_sz = _PLY_TYPES[ptype]
                        v = np.frombuffer(body, dtype=endian + it_fmt, count=1, offset=off)[0]
                        off += it_sz
                        if pname == "face_indices":
                            fi = int(v)
                if fc is not None:
                    faces.append(fc)
                    fvals.append(fi)
            if faces:
                _triangulate(faces, fvals if has_fi else None, out)
        else:
            # skip unknown fixed-stride elements; lists are walked
            for i in range(count):
                for pname, ptype, ct_type in props:
                    if ct_type is None:
                        off += _PLY_TYPES[ptype][1]
                    else:
                        ct_fmt, ct_sz = _PLY_TYPES[ct_type]
                        n = int(np.frombuffer(body, dtype=endian + ct_fmt, count=1, offset=off)[0])
                        off += ct_sz + n * _PLY_TYPES[ptype][1]


def write_ply(path: str, vertices: np.ndarray, indices: np.ndarray, normals: Optional[np.ndarray] = None):
    """Binary-little-endian PLY writer (used by scene generators/tests)."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(indices, dtype=np.int32)
    with open(path, "wb") as fh:
        props = "property float x\nproperty float y\nproperty float z\n"
        if normals is not None:
            props += "property float nx\nproperty float ny\nproperty float nz\n"
        fh.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(v)}\n{props}"
                f"element face {len(f)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            ).encode("ascii")
        )
        if normals is not None:
            n = np.asarray(normals, dtype=np.float32)
            fh.write(np.hstack([v, n]).astype("<f4").tobytes())
        else:
            fh.write(v.astype("<f4").tobytes())
        rec = np.empty((len(f), 13), dtype=np.uint8)
        rec[:, 0] = 3
        rec[:, 1:] = f.astype("<i4").view(np.uint8).reshape(len(f), 12)
        fh.write(rec.tobytes())
