""".pbrt tokenizer.

Capability match for pbrt-v3 src/core/parser.cpp's hand-written Tokenizer:
produces directive identifiers, quoted strings, numbers and brackets;
'#' comments to end of line; tracks file/line for error reporting; Include
is handled by the parser pushing a nested Tokenizer.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple, Optional

from tpu_pbrt_torch.utils.error import Error


class Token(NamedTuple):
    kind: str  # 'ident' | 'string' | 'number' | 'lbrack' | 'rbrack'
    value: object
    filename: str
    line: int


class Tokenizer:
    def __init__(self, contents: str, filename: str = "<string>"):
        self.s = contents
        self.filename = filename
        self.pos = 0
        self.line = 1
        self.n = len(contents)

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, "r", errors="replace") as f:
            return cls(f.read(), path)

    def __iter__(self) -> Iterator[Token]:
        while True:
            t = self.next()
            if t is None:
                return
            yield t

    def next(self) -> Optional[Token]:
        s, n = self.s, self.n
        # skip whitespace + comments
        while self.pos < n:
            c = s[self.pos]
            if c == "\n":
                self.line += 1
                self.pos += 1
            elif c in " \t\r":
                self.pos += 1
            elif c == "#":
                while self.pos < n and s[self.pos] != "\n":
                    self.pos += 1
            else:
                break
        if self.pos >= n:
            return None
        c = s[self.pos]
        if c == "[":
            self.pos += 1
            return Token("lbrack", "[", self.filename, self.line)
        if c == "]":
            self.pos += 1
            return Token("rbrack", "]", self.filename, self.line)
        if c == '"':
            start_line = self.line
            self.pos += 1
            out = []
            while self.pos < n and s[self.pos] != '"':
                ch = s[self.pos]
                if ch == "\n":
                    Error(f"{self.filename}:{self.line}: newline in quoted string")
                if ch == "\\" and self.pos + 1 < n:
                    self.pos += 1
                    esc = s[self.pos]
                    out.append({"n": "\n", "t": "\t", "\\": "\\", '"': '"', "r": "\r", "b": "\b", "f": "\f", "'": "'"}.get(esc, esc))
                else:
                    out.append(ch)
                self.pos += 1
            if self.pos >= n:
                Error(f"{self.filename}:{start_line}: unterminated string")
            self.pos += 1
            return Token("string", "".join(out), self.filename, start_line)
        # number or identifier: read until delimiter
        start = self.pos
        while self.pos < n and s[self.pos] not in ' \t\r\n"[]#':
            self.pos += 1
        word = s[start : self.pos]
        try:
            v = float(word)
            return Token("number", v, self.filename, self.line)
        except ValueError:
            return Token("ident", word, self.filename, self.line)


def resolve_include(path: str, current_file: str) -> str:
    """pbrt resolves Include paths relative to the including file's dir."""
    if os.path.isabs(path):
        return path
    base = os.path.dirname(os.path.abspath(current_file))
    return os.path.join(base, path)
