"""Warning/Error reporting with scene-file locations.

Capability match for pbrt-v3 src/core/error.{h,cpp} (Warning/Error with
file:line from parser state) plus glog-style severity logging via the
stdlib logging module.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("tpu_pbrt_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)

# current parse location, maintained by the parser (file, line)
_parse_loc: list = []
_quiet = False
_n_warnings = 0


class PbrtError(RuntimeError):
    pass


def set_quiet(q: bool):
    global _quiet
    _quiet = q


def push_loc(filename: str, line: int = 0):
    _parse_loc.append([filename, line])


def set_line(line: int):
    if _parse_loc:
        _parse_loc[-1][1] = line


def pop_loc():
    if _parse_loc:
        _parse_loc.pop()


def _loc() -> str:
    if _parse_loc:
        f, l = _parse_loc[-1]
        return f"{f}:{l}: "
    return ""


def Warning(msg: str):  # noqa: N802 - pbrt API name
    global _n_warnings
    _n_warnings += 1
    if not _quiet:
        logger.warning("%s%s", _loc(), msg)


def Error(msg: str):  # noqa: N802 - pbrt API name
    logger.error("%s%s", _loc(), msg)
    raise PbrtError(_loc() + msg)


def info(msg: str):
    logger.info("%s", msg)
