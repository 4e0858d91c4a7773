"""Typed parameter lists for scene directives.

Capability match for pbrt-v3 src/core/paramset.{h,cpp}: ParamSet holds typed
name->value lists declared as "type name" strings in .pbrt files
(bool/integer/float/point2/vector2/point3/vector3/normal/spectrum/rgb/color/
xyz/blackbody/string/texture), with Find*/FindOne* lookups and defaults, and
TextureParams which layers texture lookup over material+geometry param sets.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tpu_pbrt_torch.core import spectrum as spec
from tpu_pbrt_torch.utils.error import Warning as warn
from tpu_pbrt_torch.utils.fileutil import resolve_filename

# declared-type -> canonical storage kind
_TYPE_KINDS = {
    "bool": "bool",
    "integer": "int",
    "float": "float",
    "point2": "point2",
    "vector2": "vector2",
    "point3": "point3",
    "point": "point3",
    "vector3": "vector3",
    "vector": "vector3",
    "normal": "normal",
    "normal3": "normal",
    "string": "string",
    "texture": "texture",
    "rgb": "spectrum",
    "color": "spectrum",
    "xyz": "spectrum",
    "blackbody": "spectrum",
    "spectrum": "spectrum",
}


class ParamSet:
    """Typed name->values container with pbrt lookup semantics."""

    def __init__(self):
        self._params: Dict[str, tuple] = {}  # name -> (kind, values)
        self._looked_up: set = set()

    # -- construction -----------------------------------------------------
    def add(self, decl: str, values: Sequence, scene_dir: str = "."):
        """Add a parameter from its '.pbrt' declaration string, e.g.
        add("float radius", [1.0])."""
        from tpu_pbrt_torch.utils.error import Error

        parts = decl.strip().split()
        if len(parts) != 2:
            Error(f"malformed parameter declaration {decl!r}")
        type_name, name = parts
        kind = _TYPE_KINDS.get(type_name)
        if kind is None:
            Error(f"unknown parameter type {type_name!r} in {decl!r}")
        vals = self._convert(type_name, kind, name, list(values), scene_dir)
        self._params[name] = (kind, vals)

    def _convert(self, type_name, kind, name, values, scene_dir):
        if kind == "bool":
            out = []
            for v in values:
                if isinstance(v, str):
                    out.append(v == "true")
                else:
                    out.append(bool(v))
            return out
        if kind == "int":
            return [int(v) for v in values]
        if kind == "float":
            return [float(v) for v in values]
        from tpu_pbrt_torch.utils.error import Error

        if kind in ("point2", "vector2"):
            a = np.asarray([float(v) for v in values], dtype=np.float64)
            if a.size % 2:
                Error(f"parameter {name!r}: odd value count for {kind}")
            return a.reshape(-1, 2)
        if kind in ("point3", "vector3", "normal"):
            a = np.asarray([float(v) for v in values], dtype=np.float64)
            if a.size % 3:
                Error(f"parameter {name!r}: value count not multiple of 3")
            return a.reshape(-1, 3)
        if kind in ("string", "texture"):
            return [str(v) for v in values]
        if kind == "spectrum":
            return self._convert_spectrum(type_name, name, values, scene_dir)
        raise AssertionError(kind)

    @staticmethod
    def _convert_spectrum(type_name, name, values, scene_dir):
        """All spectral inputs canonicalize to linear RGB rows (n,3)."""
        from tpu_pbrt_torch.utils.error import Error

        if type_name in ("rgb", "color"):
            a = np.asarray([float(v) for v in values], dtype=np.float64)
            if a.size % 3:
                Error(f"parameter {name!r}: rgb value count not multiple of 3")
            return a.reshape(-1, 3)
        if type_name == "xyz":
            a = np.asarray([float(v) for v in values], dtype=np.float64).reshape(-1, 3)
            return np.stack([spec.xyz_to_rgb(x) for x in a])
        if type_name == "blackbody":
            # pbrt-v3: pairs of (temperature, scale)
            a = [float(v) for v in values]
            out = []
            for i in range(0, len(a), 2):
                t = a[i]
                sc = a[i + 1] if i + 1 < len(a) else 1.0
                out.append(spec.blackbody_rgb_normalized(t) * sc)
            return np.asarray(out)
        if type_name == "spectrum":
            if values and isinstance(values[0], str):
                # .spd file(s): lines of "wavelength value"
                out = []
                for fn in values:
                    lam_v = np.loadtxt(resolve_filename(fn, scene_dir)).reshape(-1, 2)
                    out.append(spec.spd_to_rgb(lam_v[:, 0], lam_v[:, 1]))
                return np.asarray(out)
            a = [float(v) for v in values]
            if len(a) < 2 or len(a) % 2:
                Error(f"parameter {name!r}: spectrum needs (wavelength, value) pairs")
            lam = np.asarray(a[0::2])
            val = np.asarray(a[1::2])
            return spec.spd_to_rgb(lam, val)[None, :]
        raise AssertionError(type_name)

    # -- typed lookups (pbrt FindOne* / Find* surface) --------------------
    def _get(self, name, kinds):
        e = self._params.get(name)
        if e is not None and e[0] in kinds:
            self._looked_up.add(name)
            return e[1]
        return None

    def find_one_float(self, name, default: float) -> float:
        v = self._get(name, ("float", "int"))
        return float(v[0]) if v is not None and len(v) else default

    def find_one_int(self, name, default: int) -> int:
        v = self._get(name, ("int", "float"))
        return int(v[0]) if v is not None and len(v) else default

    def find_one_bool(self, name, default: bool) -> bool:
        v = self._get(name, ("bool",))
        return bool(v[0]) if v is not None and len(v) else default

    def find_one_string(self, name, default: str) -> str:
        v = self._get(name, ("string",))
        return str(v[0]) if v is not None and len(v) else default

    def find_one_filename(self, name, default: str, scene_dir: str = ".") -> str:
        v = self.find_one_string(name, "")
        return resolve_filename(v, scene_dir) if v else default

    def find_texture(self, name) -> Optional[str]:
        v = self._get(name, ("texture",))
        return str(v[0]) if v is not None and len(v) else None

    def find_one_point3(self, name, default) -> np.ndarray:
        v = self._get(name, ("point3",))
        return np.asarray(v[0], dtype=np.float64) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_vector3(self, name, default) -> np.ndarray:
        v = self._get(name, ("vector3", "point3", "normal"))
        return np.asarray(v[0], dtype=np.float64) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_normal(self, name, default) -> np.ndarray:
        return self.find_one_vector3(name, default)

    def find_one_point2(self, name, default) -> np.ndarray:
        v = self._get(name, ("point2", "vector2"))
        return np.asarray(v[0], dtype=np.float64) if v is not None and len(v) else np.asarray(default, dtype=np.float64)

    def find_one_spectrum(self, name, default) -> np.ndarray:
        v = self._get(name, ("spectrum",))
        if v is not None and len(v):
            return np.asarray(v[0], dtype=np.float64)
        d = np.asarray(default, dtype=np.float64)
        return np.full(3, float(d)) if d.ndim == 0 else d

    # vector (multi-value) lookups
    def find_float(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("float", "int"))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_int(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("int", "float"))
        return np.asarray(v, dtype=np.int64) if v is not None else None

    def find_point3(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("point3",))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_vector3(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("vector3", "point3"))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_normal(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("normal", "vector3", "point3"))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_point2(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("point2", "vector2"))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_string(self, name) -> Optional[List[str]]:
        v = self._get(name, ("string",))
        return list(v) if v is not None else None

    def find_bool(self, name) -> Optional[List[bool]]:
        v = self._get(name, ("bool",))
        return list(v) if v is not None else None

    def find_spectrum(self, name) -> Optional[np.ndarray]:
        v = self._get(name, ("spectrum",))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    # -- bookkeeping ------------------------------------------------------
    def report_unused(self, context: str = ""):
        for name in self._params:
            if name not in self._looked_up:
                warn(f'parameter "{name}" not used {context}'.strip())

    def names(self):
        return list(self._params)

    def has(self, name) -> bool:
        return name in self._params

    def __repr__(self):
        return f"ParamSet({ {k: v[0] for k, v in self._params.items()} })"


class TextureParams:
    """Layered lookup: geometry params shadow material params; texture
    lookups resolve named Texture plugins (pbrt-v3 paramset.h TextureParams)."""

    def __init__(self, geom: ParamSet, material: ParamSet,
                 float_textures: Dict[str, Any], spectrum_textures: Dict[str, Any]):
        self.geom = geom
        self.material = material
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def _tex_name(self, name):
        t = self.geom.find_texture(name)
        if t is None:
            t = self.material.find_texture(name)
        return t

    def get_spectrum_texture(self, name, default):
        """Returns a texture node: ('const', rgb) or a named texture object."""
        t = self._tex_name(name)
        if t is not None:
            if t in self.spectrum_textures:
                return self.spectrum_textures[t]
            warn(f'spectrum texture "{t}" not found; using default for "{name}"')
        if self.geom.has(name):
            return ("const", self.geom.find_one_spectrum(name, default))
        if self.material.has(name):
            return ("const", self.material.find_one_spectrum(name, default))
        return ("const", np.asarray(default, dtype=np.float64) * np.ones(3))

    def get_spectrum_texture_or_none(self, name):
        t = self._tex_name(name)
        if t is not None and t in self.spectrum_textures:
            return self.spectrum_textures[t]
        if self.geom.has(name) or self.material.has(name):
            return ("const", self.find_one_spectrum(name, 0.0))
        return None

    def get_float_texture(self, name, default):
        t = self._tex_name(name)
        if t is not None:
            if t in self.float_textures:
                return self.float_textures[t]
            warn(f'float texture "{t}" not found; using default for "{name}"')
        if self.geom.has(name):
            return ("constf", self.geom.find_one_float(name, default))
        if self.material.has(name):
            return ("constf", self.material.find_one_float(name, default))
        return ("constf", float(default))

    def get_float_texture_or_none(self, name):
        t = self._tex_name(name)
        if t is not None and t in self.float_textures:
            return self.float_textures[t]
        if self.geom.has(name) or self.material.has(name):
            return ("constf", self.find_one_float(name, 0.0))
        return None

    # scalar lookups fall through geometry -> material
    def find_one_float(self, name, default):
        return self.geom.find_one_float(name, self.material.find_one_float(name, default))

    def find_one_int(self, name, default):
        return self.geom.find_one_int(name, self.material.find_one_int(name, default))

    def find_one_bool(self, name, default):
        return self.geom.find_one_bool(name, self.material.find_one_bool(name, default))

    def find_one_string(self, name, default):
        return self.geom.find_one_string(name, self.material.find_one_string(name, default))

    def find_one_spectrum(self, name, default):
        return self.geom.find_one_spectrum(name, self.material.find_one_spectrum(name, default))
