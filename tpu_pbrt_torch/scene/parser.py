""".pbrt directive parser.

Capability match for pbrt-v3 src/core/parser.cpp: pulls tokens from the
Tokenizer, dispatches each directive to the PbrtAPI state machine, parses
'"type name" [values]' parameter lists into ParamSets, and handles Include
by pushing a nested tokenizer.
"""

from __future__ import annotations

from typing import List, Optional

from tpu_pbrt_torch.scene.lexer import Token, Tokenizer, resolve_include
from tpu_pbrt_torch.scene.paramset import ParamSet
from tpu_pbrt_torch.utils.error import Error, pop_loc, push_loc, set_line


class _TokenStream:
    def __init__(self, tok: Tokenizer):
        self.stack: List[Tokenizer] = [tok]
        self.pushed: Optional[Token] = None

    def next(self) -> Optional[Token]:
        if self.pushed is not None:
            t, self.pushed = self.pushed, None
            return t
        while self.stack:
            t = self.stack[-1].next()
            if t is not None:
                set_line(t.line)
                return t
            self.stack.pop()
            pop_loc()
        return None

    def push_back(self, t: Token):
        assert self.pushed is None
        self.pushed = t

    def include(self, path: str):
        try:
            tok = Tokenizer.from_file(path)
        except OSError as e:
            Error(f"Include: couldn't open {path!r}: {e.strerror}")
            return
        self.stack.append(tok)
        push_loc(path)


def _expect_numbers(ts: _TokenStream, n: int, directive: str) -> List[float]:
    out = []
    brack = False
    while len(out) < n:
        t = ts.next()
        if t is None:
            Error(f"Premature EOF reading arguments of {directive}")
        if t.kind == "lbrack":
            brack = True
            continue
        if t.kind != "number":
            Error(f"{directive}: expected number, got {t.value!r}")
        out.append(float(t.value))
    if brack:
        t = ts.next()
        if t is None or t.kind != "rbrack":
            if t is not None:
                ts.push_back(t)
    return out


def _expect_string(ts: _TokenStream, directive: str) -> str:
    t = ts.next()
    if t is None or t.kind != "string":
        Error(f"{directive}: expected quoted string" + (f", got {t.value!r}" if t else " (EOF)"))
    return t.value


def _parse_params(ts: _TokenStream, scene_dir: str) -> ParamSet:
    """Parse zero or more '"type name" value-or-[values]' entries."""
    ps = ParamSet()
    while True:
        t = ts.next()
        if t is None:
            return ps
        if t.kind != "string":
            ts.push_back(t)
            return ps
        decl = t.value
        values: list = []
        t2 = ts.next()
        if t2 is None:
            Error(f"Premature EOF after parameter declaration {decl!r}")
        if t2.kind == "lbrack":
            while True:
                t3 = ts.next()
                if t3 is None:
                    Error(f"Premature EOF in value list of {decl!r}")
                if t3.kind == "rbrack":
                    break
                if t3.kind in ("number", "string"):
                    values.append(t3.value)
                elif t3.kind == "ident" and t3.value in ("true", "false"):
                    values.append(t3.value)
                else:
                    Error(f"Unexpected token {t3.value!r} in value list of {decl!r}")
        elif t2.kind in ("number", "string"):
            values.append(t2.value)
        elif t2.kind == "ident" and t2.value in ("true", "false"):
            values.append(t2.value)
        else:
            Error(f"Expected value after parameter declaration {decl!r}")
        ps.add(decl, values, scene_dir)
    return ps


def parse_tokens(tok: Tokenizer, api, render: bool = False):
    ts = _TokenStream(tok)
    push_loc(tok.filename)
    try:
        _parse_loop(ts, api, render)
    finally:
        while ts.stack:
            ts.stack.pop()
            pop_loc()


def _parse_loop(ts: _TokenStream, api, render: bool):
    sd = lambda: api.scene_dir  # noqa: E731
    while True:
        t = ts.next()
        if t is None:
            return
        if t.kind != "ident":
            Error(f"Unexpected token at top level: {t.value!r}")
            continue
        d = t.value
        if d == "Include":
            path = _expect_string(ts, d)
            ts.include(resolve_include(path, t.filename))
        elif d == "Identity":
            api.identity()
        elif d == "Translate":
            api.translate(*_expect_numbers(ts, 3, d))
        elif d == "Scale":
            api.scale(*_expect_numbers(ts, 3, d))
        elif d == "Rotate":
            api.rotate(*_expect_numbers(ts, 4, d))
        elif d == "LookAt":
            api.look_at(*_expect_numbers(ts, 9, d))
        elif d == "Transform":
            api.transform(_expect_numbers(ts, 16, d))
        elif d == "ConcatTransform":
            api.concat_transform(_expect_numbers(ts, 16, d))
        elif d == "CoordinateSystem":
            api.coordinate_system(_expect_string(ts, d))
        elif d == "CoordSysTransform":
            api.coord_sys_transform(_expect_string(ts, d))
        elif d == "ActiveTransform":
            t2 = ts.next()
            if t2 is None or t2.kind != "ident":
                Error("ActiveTransform: expected All/StartTime/EndTime")
            if t2.value == "All":
                api.active_transform_all()
            elif t2.value == "StartTime":
                api.active_transform_start()
            elif t2.value == "EndTime":
                api.active_transform_end()
            else:
                Error(f"ActiveTransform: unknown time {t2.value!r}")
        elif d == "TransformTimes":
            api.transform_times(*_expect_numbers(ts, 2, d))
        elif d == "PixelFilter":
            name = _expect_string(ts, d)
            api.pixel_filter(name, _parse_params(ts, sd()))
        elif d == "Film":
            name = _expect_string(ts, d)
            api.film(name, _parse_params(ts, sd()))
        elif d == "Sampler":
            name = _expect_string(ts, d)
            api.sampler(name, _parse_params(ts, sd()))
        elif d == "Accelerator":
            name = _expect_string(ts, d)
            api.accelerator(name, _parse_params(ts, sd()))
        elif d == "Integrator":
            name = _expect_string(ts, d)
            api.integrator(name, _parse_params(ts, sd()))
        elif d == "Camera":
            name = _expect_string(ts, d)
            api.camera(name, _parse_params(ts, sd()))
        elif d == "MakeNamedMedium":
            name = _expect_string(ts, d)
            api.make_named_medium(name, _parse_params(ts, sd()))
        elif d == "MediumInterface":
            inside = _expect_string(ts, d)
            t2 = ts.next()
            outside = ""
            if t2 is not None and t2.kind == "string":
                outside = t2.value
            elif t2 is not None:
                ts.push_back(t2)
            api.medium_interface(inside, outside)
        elif d == "WorldBegin":
            api.world_begin()
        elif d == "WorldEnd":
            api.world_end(render=render)
        elif d == "AttributeBegin":
            api.attribute_begin()
        elif d == "AttributeEnd":
            api.attribute_end()
        elif d == "TransformBegin":
            api.transform_begin()
        elif d == "TransformEnd":
            api.transform_end()
        elif d == "Texture":
            name = _expect_string(ts, d)
            type_name = _expect_string(ts, d)
            tex_class = _expect_string(ts, d)
            api.texture(name, type_name, tex_class, _parse_params(ts, sd()))
        elif d == "Material":
            name = _expect_string(ts, d)
            api.material(name, _parse_params(ts, sd()))
        elif d == "MakeNamedMaterial":
            name = _expect_string(ts, d)
            api.make_named_material(name, _parse_params(ts, sd()))
        elif d == "NamedMaterial":
            api.named_material(_expect_string(ts, d))
        elif d == "LightSource":
            name = _expect_string(ts, d)
            api.light_source(name, _parse_params(ts, sd()))
        elif d == "AreaLightSource":
            name = _expect_string(ts, d)
            api.area_light_source(name, _parse_params(ts, sd()))
        elif d == "Shape":
            name = _expect_string(ts, d)
            api.shape(name, _parse_params(ts, sd()))
        elif d == "ReverseOrientation":
            api.reverse_orientation()
        elif d == "ObjectBegin":
            api.object_begin(_expect_string(ts, d))
        elif d == "ObjectEnd":
            api.object_end()
        elif d == "ObjectInstance":
            api.object_instance(_expect_string(ts, d))
        else:
            Error(f"Unknown directive: {d}")
