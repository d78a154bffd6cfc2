"""Reader for the block-mapping subset of YAML that the planner's configs use.

The configs (``configs/*.yaml``, schema-compatible with the reference's
``test/config_files/*.yaml``) are nested block mappings of plain or quoted
single-line scalars with ``#`` comments.  This reader parses exactly that
subset, resolving scalars the way ``yaml.safe_load`` (YAML 1.1) does, and
raises ``ValueError`` on anything else — flow collections, sequences,
anchors and aliases, tags, multi-line scalars, several documents — rather
than guess.  It keeps the package free of a YAML dependency.
"""
from __future__ import annotations

import re

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
_UNSUPPORTED = "[]{}&*!|>%@`"


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (start of line or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str):
    s = text.strip()
    if s[:1] in ("'", '"'):
        q = s[0]
        if len(s) < 2 or s[-1] != q or q in s[1:-1] or "\\" in s:
            raise ValueError(f"{where}: unsupported quoted scalar {s!r}")
        return s[1:-1]
    if s[:1] and s[0] in _UNSUPPORTED or s.startswith(("- ", "? ")) \
            or s == "-":
        raise ValueError(f"{where}: unsupported YAML syntax {s!r} (only "
                         "block mappings of single-line scalars are read)")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and any(c.isdigit() for c in s):
        return float(s.replace("_", ""))
    if re.match(r"[-+]?(0[0-9xXoObB_]|[0-9][0-9_]*:)", s):
        raise ValueError(f"{where}: unsupported number form {s!r} (octal, "
                         "hex, binary or sexagesimal)")
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def loads(text: str) -> dict:
    """Parse a config document into nested dicts (see module doc)."""
    root: dict = {}
    # stack of (indent of the mapping's keys, mapping); a key whose value
    # is empty opens a child mapping at a deeper indent on the next line
    stack = [(0, root)]
    pending = None  # (parent mapping, key, parent indent) awaiting a child
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.startswith(("---", "...", "%")):
            raise ValueError(f"{where}: unsupported document marker")
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        if pending is not None:
            parent, key, pindent = pending
            pending = None
            if indent > pindent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        m = re.match(r"(.+?):(\s+(.*))?$", body)
        if m is None or body.startswith(("- ", "? ")):
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key = _scalar(m.group(1), where)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        value = (m.group(3) or "").strip()
        if ": " in value or value.endswith(":"):
            raise ValueError(f"{where}: unsupported inline mapping {value!r}")
        if value:
            mapping[key] = _scalar(value, where)
        else:
            pending = (mapping, key, indent)
    if pending is not None:
        pending[0][pending[1]] = None
    return root
