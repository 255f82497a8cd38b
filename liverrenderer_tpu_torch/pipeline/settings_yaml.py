"""A reader of the YAML subset that the fork's RendererSettings.yml uses,
so that the pipeline needs no YAML package: block mappings (nested by
indentation), plain and quoted keys (a quoted key may end in a space, as
"Max Depth " does), scalar values (int, float, bool, null, plain, single-
and double-quoted strings), and '#' comments.  Plain scalars resolve as
PyYAML's `safe_load` resolves them (YAML 1.1: "yes" and "on" are true,
a float needs a '.', "1e5" stays a string).

Anything outside the subset (sequences, flow collections, anchors, tags,
block or multi-line scalars, octal, hex and sexagesimal numbers, dates,
tabs in indentation) raises ValueError naming the file and line.
"""
from __future__ import annotations

import math
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
# YAML 1.1 forms that PyYAML resolves and this reader does not carry
_OTHER = re.compile(r"[-+]?0b[01_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                    r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?$"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_INDICATORS = "[]{}&*!|>%@`,?"
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0", " ": " "}


def load(path: str) -> dict:
    """The file's top-level mapping as a dict."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), path)


def loads(text: str, name: str = "<string>") -> dict:
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _error(name, no, "a tab in the indentation")
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if not lines and body.rstrip() == "---":
            continue                       # the document's start marker
        lines.append((no, len(raw) - len(body), body.rstrip()))
    if not lines:
        return {}
    out, i = _mapping(lines, 0, lines[0][1], name)
    if i != len(lines):
        raise _error(name, lines[i][0], "indentation out of place")
    return out


def _error(name, no, what):
    return ValueError(f"{name}:{no}: {what} (outside the YAML subset that "
                      "liverrenderer_tpu_torch.pipeline.settings_yaml reads)")


def _mapping(lines, i, indent, name):
    out = {}
    while i < len(lines):
        no, ind, s = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _error(name, no, "indentation out of place")
        key, rest = _key(s, no, name)
        i += 1
        if _ends_at_colon(rest):
            if i < len(lines) and lines[i][1] > indent:
                val, i = _mapping(lines, i, lines[i][1], name)
            else:
                val = None
        else:
            val = _scalar(rest, no, name)
        out[key] = val
    return out, i


def _quoted(s, no, name):
    """A quoted scalar at the start of s -> (its value, the rest of s)."""
    q = s[0]
    out = []
    j = 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), s[j + 1:]
        if q == '"' and c == "\\":
            esc = s[j + 1:j + 2]
            if esc not in _ESCAPES:
                raise _error(name, no, f"the escape \\{esc}")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), s[j + 1:]
        out.append(c)
        j += 1
    raise _error(name, no, "an unterminated or multi-line quoted scalar")


def _key(s, no, name):
    """'key: rest' -> (key, rest)."""
    if s[0] in "\"'":
        key, rest = _quoted(s, no, name)
        rest = rest.lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            raise _error(name, no, "expected 'key: value'")
        return key, rest[1:]
    m = re.search(r":( |$)", s)
    if m is None or s.startswith(("- ", "-\t")) or s == "-":
        raise _error(name, no, "expected 'key: value'")
    key = s[:m.start()].rstrip()
    return _plain(key, no, name), s[m.start() + 1:]


def _ends_at_colon(rest):
    """Whether nothing but a comment follows the key's colon."""
    rest = rest.strip()
    return not rest or rest.startswith("#")


def _scalar(rest, no, name):
    rest = rest.strip()
    if rest[0] in "\"'":
        val, tail = _quoted(rest, no, name)
        tail = tail.strip()
        if tail and not tail.startswith("#"):
            raise _error(name, no, "text after a quoted scalar")
        return val
    m = re.search(r"\s#", rest)
    if m is not None:
        rest = rest[:m.start()].rstrip()
    if re.search(r":( |$)", rest):
        raise _error(name, no, "a mapping inside a value")
    return _plain(rest, no, name)


def _plain(s, no, name):
    """A plain scalar resolved as PyYAML's safe_load resolves it."""
    if s[:1] in _INDICATORS or s[:2] in ("- ", "? ", ": ") or s in ("-",):
        raise _error(name, no, f"the indicator in {s!r}")
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if _OTHER.match(s):
        raise _error(name, no, f"the scalar {s!r}")
    return s
