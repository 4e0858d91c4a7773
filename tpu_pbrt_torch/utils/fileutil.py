"""File path utilities.

Capability match for pbrt-v3 src/core/fileutil.{h,cpp}: ResolveFilename
(scene-relative path resolution) and ReadFloatFile (whitespace/comment
tolerant float lists, used by RealisticCamera lens files and .spd spectra).
"""

from __future__ import annotations

import os
from typing import List


def resolve_filename(filename: str, scene_dir: str = ".") -> str:
    """Resolve a scene-file-relative path (pbrt ResolveFilename)."""
    if not filename or os.path.isabs(filename):
        return filename
    return os.path.join(scene_dir, filename)


def read_float_file(path: str) -> List[float]:
    """pbrt ReadFloatFile: all whitespace-separated floats, '#' comments."""
    out: List[float] = []
    with open(path) as f:
        for line in f:
            body = line.split("#", 1)[0]
            out.extend(float(t) for t in body.split())
    return out
