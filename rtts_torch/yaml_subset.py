"""A reader for the YAML that the config files use, with no PyYAML.

``safe_load(text)`` gives what ``yaml.safe_load`` gives on the subset that
``configs/*.yaml`` and ``rtts_torch.config.save_config`` write:

- block mappings, nested by indentation (spaces), and ``#`` comments;
- flow mappings (``{kind: full, num_heads: 2}``) and flow sequences
  (``[local, lsh]``), nested, on one line or several;
- single- and double-quoted scalars (JSON's escapes and YAML's), and plain
  scalars resolved by YAML 1.1's rules as PyYAML's resolver applies them:
  ``2.0e-4`` is a float but ``1e-5`` (no dot) and ``1.0e5`` (no exponent
  sign) are strings; ``yes``/``no``/``on``/``off``/``true``/``false`` in
  their three casings are bools; ``null``/``~``/nothing is None; ints may
  be binary (``0b``), octal (a leading 0), hex (``0x``), sexagesimal
  (``1:30``) or carry ``_``.

Anything else raises ``ValueError`` naming the line: block sequences,
anchors and aliases, tags, block scalars (``|``, ``>``), multi-line plain
or quoted scalars, directives, several documents, timestamps and merge
keys.  The reader never guesses.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["safe_load"]

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"


def _sexagesimal(digits: str, kind):
    value = kind(0)
    for part in digits.split(":"):
        value = value * 60 + kind(part)
    return value


def _resolve(text: str, where: str) -> Any:
    """A plain scalar's value by YAML 1.1's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text == "<<" or text == "=":
        raise ValueError(f"{where}: merge and value keys ({text!r}) are "
                         "outside the YAML subset")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * (_sexagesimal(value, float) if ":" in value
                        else float(value))
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _TIMESTAMP.match(text):
        raise ValueError(f"{where}: timestamps ({text!r}) are outside the "
                         "YAML subset; quote the value")
    return text


class _Text:
    """A run of source text (one line, or a flow collection's lines joined
    by newlines) and the number of its first line, for messages."""

    def __init__(self, text: str, line: int, name: str):
        self.s, self.line, self.name = text, line, name

    def where(self, pos: int) -> str:
        return f"{self.name}:{self.line + self.s.count(chr(10), 0, pos)}"

    def fail(self, pos: int, what: str):
        raise ValueError(f"{self.where(pos)}: {what}")

    def skip_space(self, pos: int, newlines: bool) -> int:
        """Past spaces (and newlines and comments when ``newlines``)."""
        s = self.s
        while pos < len(s):
            c = s[pos]
            if c == " " or c == "\t" or (newlines and c == "\n"):
                pos += 1
            elif c == "#" and (pos == 0 or s[pos - 1] in " \t\n"):
                nl = s.find("\n", pos)
                if not newlines or nl < 0:
                    return len(s)
                pos = nl
            else:
                break
        return pos


def _check_indicator(t: _Text, pos: int) -> None:
    """Raise on a node that starts with an indicator outside the subset."""
    c = t.s[pos]
    nxt = t.s[pos + 1:pos + 2]
    if c in "&*":
        t.fail(pos, "anchors and aliases are outside the YAML subset")
    if c == "!":
        t.fail(pos, "tags are outside the YAML subset")
    if c in "|>":
        t.fail(pos, "block scalars ('|', '>') are outside the YAML subset")
    if c in "%@`":
        t.fail(pos, f"a plain scalar cannot start with {c!r}")
    if c in "-?:" and nxt in ("", " ", "\t", "\n"):
        what = {"-": "block sequences", "?": "complex keys",
                ":": "empty keys"}[c]
        t.fail(pos, f"{what} are outside the YAML subset")


def _quoted(t: _Text, pos: int) -> Tuple[str, int]:
    """A quoted scalar at ``pos`` -> (value, position after it)."""
    s, q = t.s, t.s[pos]
    out: List[str] = []
    i = pos + 1
    while True:
        if i >= len(s) or s[i] == "\n":
            t.fail(pos, "a quoted scalar must end on its line")
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
        elif c == '"':
            return "".join(out), i + 1
        elif c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    t.fail(i, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            t.fail(i, f"escape \\{e or 'at the end of the line'} is outside "
                   "the YAML subset")
        out.append(c)
        i += 1


def _plain(t: _Text, pos: int, flow: bool) -> Tuple[str, int]:
    """A plain scalar's text at ``pos`` -> (text, position after it).  It
    ends at a comment, at ': ', at the line's end and, in a flow
    collection, at ',[]{}' and at ':' before one of them."""
    s = t.s
    i = pos
    while i < len(s):
        c = s[i]
        nxt = s[i + 1:i + 2]
        if c == "\n":
            break
        if c == "#" and i > 0 and s[i - 1] in " \t":
            break
        if c == ":" and (nxt in ("", " ", "\t", "\n")
                         or (flow and nxt in _FLOW_END)):
            break
        if flow and c in _FLOW_END:
            break
        i += 1
    return s[pos:i].rstrip(" \t"), i


def _flow_node(t: _Text, pos: int) -> Tuple[Any, int]:
    """A node inside (or opening) a flow collection."""
    pos = t.skip_space(pos, newlines=True)
    if pos >= len(t.s):
        t.fail(pos, "unterminated flow collection")
    c = t.s[pos]
    if c == "[":
        return _flow_seq(t, pos)
    if c == "{":
        return _flow_map(t, pos)
    if c in "'\"":
        return _quoted(t, pos)
    if c in ",]}":
        t.fail(pos, f"unexpected {c!r}")
    _check_indicator(t, pos)
    text, end = _plain(t, pos, flow=True)
    after = t.skip_space(end, newlines=True)
    if "\n" in t.s[end:after] and t.s[after:after + 1] not in (
            "", ":", *_FLOW_END):
        t.fail(end, "multi-line plain scalars are outside the YAML subset")
    return _resolve(text, t.where(pos)), end


def _flow_seq(t: _Text, pos: int) -> Tuple[list, int]:
    out: list = []
    pos += 1
    while True:
        pos = t.skip_space(pos, newlines=True)
        if pos >= len(t.s):
            t.fail(pos, "unterminated flow sequence")
        if t.s[pos] == "]":
            return out, pos + 1
        item, pos = _flow_node(t, pos)
        pos = t.skip_space(pos, newlines=True)
        if pos >= len(t.s):
            t.fail(pos, "unterminated flow sequence")
        nxt = t.s[pos:pos + 1]
        if nxt == ":":
            t.fail(pos, "mappings inside a flow sequence are outside the "
                   "YAML subset")
        out.append(item)
        if nxt == ",":
            pos += 1
        elif nxt != "]":
            t.fail(pos, "expected ',' or ']' in a flow sequence")


def _flow_map(t: _Text, pos: int) -> Tuple[dict, int]:
    out: dict = {}
    pos += 1
    while True:
        pos = t.skip_space(pos, newlines=True)
        if pos >= len(t.s):
            t.fail(pos, "unterminated flow mapping")
        if t.s[pos] == "}":
            return out, pos + 1
        if t.s[pos] in "[{":
            t.fail(pos, "collection keys are outside the YAML subset")
        key, pos = _flow_node(t, pos)
        pos = t.skip_space(pos, newlines=True)
        value = None
        if t.s[pos:pos + 1] == ":":
            pos = t.skip_space(pos + 1, newlines=True)
            if t.s[pos:pos + 1] not in (",", "}"):
                value, pos = _flow_node(t, pos)
                pos = t.skip_space(pos, newlines=True)
        if pos >= len(t.s):
            t.fail(pos, "unterminated flow mapping")
        out[key] = value
        nxt = t.s[pos:pos + 1]
        if nxt == ",":
            pos += 1
        elif nxt != "}":
            t.fail(pos, "expected ',' or '}' in a flow mapping")


def _end_of_line(t: _Text, pos: int) -> None:
    """Only spaces and a comment may follow a node on its line."""
    end = t.skip_space(pos, newlines=False)
    if end < len(t.s) and t.s[end] != "\n":
        t.fail(end, f"unexpected text after the value: {t.s[end:]!r}")


class _Lines:
    """The document's content lines: (number, indent, text without the
    indent); blank and comment-only lines are left out."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.rows: List[Tuple[int, int, str]] = []
        started = ended = False
        for n, raw in enumerate(text.lstrip("\ufeff").split("\n"), 1):
            raw = raw.rstrip("\r")
            body = raw.lstrip(" ")
            if not body.strip() or body.lstrip().startswith("#"):
                continue
            if body.startswith("\t"):
                raise ValueError(f"{name}:{n}: tabs in indentation are "
                                 "outside the YAML subset")
            indent = len(raw) - len(body)
            marker = body.split(" #")[0].rstrip() if indent == 0 else ""
            if ended or (marker == "---" and started):
                raise ValueError(f"{name}:{n}: several documents are outside "
                                 "the YAML subset")
            if indent == 0 and body.startswith(("%", "--- ", "... ")):
                raise ValueError(f"{name}:{n}: directives and nodes on a "
                                 "document marker line are outside the YAML "
                                 "subset")
            started = True
            if marker == "...":
                ended = True
            elif marker != "---":
                self.rows.append((n, indent, body))

    def text(self, i: int) -> _Text:
        n, _, body = self.rows[i]
        return _Text(body, n, self.name)


def _key(t: _Text) -> Optional[Tuple[Any, int]]:
    """A block mapping line's key -> (key, position after its ':'), or None
    when the line is not ``key: ...``."""
    s = t.s
    if s[0] in "'\"":
        key, pos = _quoted(t, 0)
        pos = t.skip_space(pos, newlines=False)
        if s[pos:pos + 1] != ":" or s[pos + 1:pos + 2] not in ("", " ", "\t"):
            return None
        return key, pos + 1
    if s[0] in "[{":
        return None
    _check_indicator(t, 0)
    text, pos = _plain(t, 0, flow=False)
    if s[pos:pos + 1] != ":":
        return None
    return _resolve(text, t.where(0)), pos + 1


class _Reader:
    def __init__(self, text: str, name: str):
        self.lines = _Lines(text, name)
        self.i = 0

    def _indent(self) -> Optional[int]:
        rows = self.lines.rows
        return rows[self.i][1] if self.i < len(rows) else None

    def _value(self, t: _Text, pos: int, indent: int) -> Any:
        """The value after a key's ':' (or a whole-document node)."""
        pos = t.skip_space(pos, newlines=False)
        if pos >= len(t.s):
            nxt = self._indent()
            if nxt is not None and nxt > indent:
                return self._mapping(nxt)
            return None
        c = t.s[pos]
        if c in "[{":
            return self._flow(t, pos, indent)
        if c in "'\"":
            value, end = _quoted(t, pos)
        else:
            _check_indicator(t, pos)
            text, end = _plain(t, pos, flow=False)
            if t.s[end:end + 1] == ":":
                t.fail(end, "a mapping value on its key's line is outside "
                       "the YAML subset")
            value = _resolve(text, t.where(pos))
        _end_of_line(t, end)
        self._no_deeper(indent, "multi-line scalars are outside the YAML "
                        "subset")
        return value

    def _flow(self, t: _Text, pos: int, indent: int) -> Any:
        """A flow collection from ``pos``, pulling in the next lines until
        it closes."""
        while True:
            try:
                value, end = _flow_node(t, pos)
                break
            except ValueError as e:
                nxt = self._indent()
                if "unterminated" not in str(e) or nxt is None:
                    raise
                n, _, body = self.lines.rows[self.i]
                self.i += 1
                gap = n - (t.line + t.s.count("\n"))
                t = _Text(t.s + "\n" * gap + " " * nxt + body, t.line, t.name)
        _end_of_line(t, end)
        self._no_deeper(indent, "unexpected indentation after a flow "
                        "collection")
        return value

    def _no_deeper(self, indent: int, what: str) -> None:
        nxt = self._indent()
        if nxt is not None and nxt > indent:
            n = self.lines.rows[self.i][0]
            raise ValueError(f"{self.lines.name}:{n}: {what}")

    def _mapping(self, indent: int) -> dict:
        out: dict = {}
        while self._indent() == indent:
            t = self.lines.text(self.i)
            found = _key(t)
            if found is None:
                t.fail(0, "expected 'key: value' in a block mapping")
            self.i += 1
            key, pos = found
            out[key] = self._value(t, pos, indent)
        nxt = self._indent()
        if nxt is not None and nxt > indent:
            n = self.lines.rows[self.i][0]
            raise ValueError(f"{self.lines.name}:{n}: unexpected indentation")
        return out

    def document(self) -> Any:
        rows = self.lines.rows
        if not rows:
            return None
        indent = rows[0][1]
        t = self.lines.text(0)
        if _key(t) is not None:
            value = self._mapping(indent)
        else:   # a flow collection or a scalar: the whole document
            self.i = 1
            value = self._value(t, 0, -1)
        if self.i < len(rows):
            n = rows[self.i][0]
            raise ValueError(f"{self.lines.name}:{n}: bad indentation")
        return value


def safe_load(text: str, name: str = "<yaml>") -> Any:
    """What ``yaml.safe_load(text)`` gives, for the subset this module
    reads; ``ValueError`` ("name:line: ...") outside it."""
    return _Reader(text, name).document()
