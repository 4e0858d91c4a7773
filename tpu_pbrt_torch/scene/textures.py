"""Texture plugin factories.

Capability match for pbrt-v3 src/textures/ (constant, scale, mix, bilerp,
imagemap, checkerboard, dots, fbm, wrinkled, marble, windy, uv) and the
Create*Texture factories in api.cpp's MakeFloatTexture/MakeSpectrumTexture.

Textures are captured as declarative nodes (nested tuples/dicts) at parse
time; the scene compiler lowers them to device-evaluable forms: constants
fold into material parameter slots, image maps go into a mip-mapped texture
atlas, procedural nodes are evaluated by jitted noise code at shade time.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from tpu_pbrt_torch.core.transform import Transform
from tpu_pbrt_torch.scene.paramset import TextureParams
from tpu_pbrt_torch.utils.error import Error, Warning
from tpu_pbrt_torch.utils.fileutil import resolve_filename


def _mapping2d(tp: TextureParams, tex_to_world: Transform) -> dict:
    """pbrt TextureMapping2D factory (texture.cpp GetMapping2D)."""
    m = {"type": tp.find_one_string("mapping", "uv")}
    if m["type"] == "uv":
        m.update(
            su=tp.find_one_float("uscale", 1.0),
            sv=tp.find_one_float("vscale", 1.0),
            du=tp.find_one_float("udelta", 0.0),
            dv=tp.find_one_float("vdelta", 0.0),
        )
    elif m["type"] == "planar":
        m.update(
            v1=np.asarray(tp.geom.find_one_vector3("v1", [1, 0, 0])),
            v2=np.asarray(tp.geom.find_one_vector3("v2", [0, 1, 0])),
            du=tp.find_one_float("udelta", 0.0),
            dv=tp.find_one_float("vdelta", 0.0),
        )
    elif m["type"] in ("spherical", "cylindrical"):
        m["world_to_texture"] = tex_to_world.inverse()
    else:
        Error(f'2D texture mapping "{m["type"]}" unknown')
    return m


def _mapping3d(tp: TextureParams, tex_to_world: Transform) -> dict:
    return {"world_to_texture": tex_to_world.inverse()}


def _imagemap(kind: str, tex_to_world, tp: TextureParams, scene_dir: str) -> tuple:
    filename = tp.find_one_string("filename", "")
    path = resolve_filename(filename, scene_dir)
    return (
        "imagemap",
        {
            "kind": kind,
            "filename": path,
            "mapping": _mapping2d(tp, tex_to_world),
            "trilerp": tp.find_one_bool("trilinear", False),
            "max_aniso": tp.find_one_float("maxanisotropy", 8.0),
            "wrap": tp.find_one_string("wrap", "repeat"),
            "scale": tp.find_one_float("scale", 1.0),
            "gamma": tp.find_one_bool(
                "gamma", filename.lower().endswith((".tga", ".png", ".jpg", ".jpeg"))
            ),
        },
    )


def _noise_common(name, kind, tex_to_world, tp):
    d = {
        "kind": kind,
        "mapping": _mapping3d(tp, tex_to_world),
        "octaves": tp.find_one_int("octaves", 8),
        "roughness": tp.find_one_float("roughness", 0.5),
    }
    if name == "marble":
        d["scale"] = tp.find_one_float("scale", 1.0)
        d["variation"] = tp.find_one_float("variation", 0.2)
    return (name, d)


def _make_texture(name: str, kind: str, tex_to_world: Transform, tp: TextureParams, scene_dir: str):
    get = tp.get_float_texture if kind == "float" else tp.get_spectrum_texture
    one = 1.0 if kind == "float" else np.ones(3)
    zero = 0.0 if kind == "float" else np.zeros(3)
    if name == "constant":
        v = tp.find_one_float("value", 1.0) if kind == "float" else tp.find_one_spectrum("value", 1.0)
        return ("constf", v) if kind == "float" else ("const", v)
    if name == "scale":
        return ("scale", get("tex1", one), get("tex2", one))
    if name == "mix":
        return ("mix", get("tex1", zero), get("tex2", one), tp.get_float_texture("amount", 0.5))
    if name == "bilerp":
        return (
            "bilerp",
            {
                "v00": get("v00", zero),
                "v01": get("v01", one),
                "v10": get("v10", zero),
                "v11": get("v11", one),
                "mapping": _mapping2d(tp, tex_to_world),
            },
        )
    if name == "imagemap":
        return _imagemap(kind, tex_to_world, tp, scene_dir)
    if name == "uv":
        return ("uv", {"mapping": _mapping2d(tp, tex_to_world)})
    if name == "checkerboard":
        dim = tp.find_one_int("dimension", 2)
        if dim not in (2, 3):
            Error(f"{dim} dimensional checkerboard texture not supported")
        d = {
            "dim": dim,
            "tex1": get("tex1", one),
            "tex2": get("tex2", zero),
            "aamode": tp.find_one_string("aamode", "closedform"),
        }
        d["mapping"] = _mapping2d(tp, tex_to_world) if dim == 2 else _mapping3d(tp, tex_to_world)
        return ("checkerboard", d)
    if name == "dots":
        return (
            "dots",
            {
                "inside": get("inside", one),
                "outside": get("outside", zero),
                "mapping": _mapping2d(tp, tex_to_world),
            },
        )
    if name in ("fbm", "wrinkled", "windy", "marble"):
        return _noise_common(name, kind, tex_to_world, tp)
    if name == "ptex":
        Warning('ptex textures are approximated as constant gray (convert to imagemap for full fidelity)')
        return ("constf", 0.5) if kind == "float" else ("const", np.full(3, 0.5))
    Warning(f'{kind} texture "{name}" unknown; using constant')
    return ("constf", 0.5) if kind == "float" else ("const", np.full(3, 0.5))


def make_float_texture(name: str, tex_to_world: Transform, tp: TextureParams, scene_dir: str = "."):
    return _make_texture(name, "float", tex_to_world, tp, scene_dir)


def make_spectrum_texture(name: str, tex_to_world: Transform, tp: TextureParams, scene_dir: str = "."):
    return _make_texture(name, "spectrum", tex_to_world, tp, scene_dir)
