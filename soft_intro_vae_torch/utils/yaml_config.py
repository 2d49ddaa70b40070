"""A reader for the subset of YAML that configs/*.yaml use.

The GPU machine the port runs on has no PyYAML, so the style trainer reads
its configs with this module. It covers what the configs and the CLI's KEY
VALUE overrides use, with PyYAML's ``safe_load`` readings (YAML 1.1):

  * block mappings nested by indentation (``KEY: value`` and ``KEY:``);
  * plain scalars resolved as PyYAML resolves them: null (``~``, ``null``,
    empty), bool (``true``/``yes``/``on`` ... in three casings), int
    (decimal, ``0x``, ``0b``, leading-0 octal, ``_`` separators, base 60
    ``1:30``), float (a ``.`` is required: ``1e-5`` stays a string, as in
    PyYAML; ``.inf``, ``.nan``, base 60), anything else a string;
  * single- and double-quoted strings;
  * flow lists of scalars, ``[2048, 2048, 1024]`` and ``[]``;
  * ``#`` comments.

Anything else (block sequences, anchors, flow mappings, multi-line
scalars) raises ``ValueError`` instead of being read differently.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DQ_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0", "r": "\r"}


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if ":" in body:
        return _sexagesimal(t, int)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return _sexagesimal(t, float)
    return float(t)


def _quoted(text: str) -> str:
    body = text[1:-1]
    if text[0] == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            if i + 1 >= len(body) or body[i + 1] not in _DQ_ESCAPES:
                raise ValueError(f"unsupported escape in {text!r}")
            out.append(_DQ_ESCAPES[body[i + 1]])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _split_flow(body: str) -> List[str]:
    items, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur).strip())
            cur = []
        elif ch in "[]{}":
            raise ValueError(f"nested flow collections are not supported: [{body}]")
        else:
            cur.append(ch)
    items.append("".join(cur).strip())
    if items[-1] == "":
        items.pop()  # "[]", or one trailing comma as PyYAML allows
    if "" in items:
        raise ValueError(f"empty entry in flow list [{body}]")
    return items


def parse_scalar(text: str) -> Any:
    """One value as ``yaml.safe_load`` reads it: a scalar or a flow list of scalars."""
    t = _strip_comment(text).strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"unterminated flow list: {text!r}")
        return [parse_scalar(item) for item in _split_flow(t[1:-1])]
    if t.startswith(("{", "&", "*", "!", "|", ">", "%", "@", "`")):
        raise ValueError(f"unsupported YAML value: {text!r}")
    if len(t) >= 2 and t[0] in "'\"" and t[-1] == t[0]:
        return _quoted(t)
    if ": " in t or t.endswith(":") or t.startswith("- "):
        raise ValueError(f"only scalars and flow lists are supported as values: {text!r}")
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return _int(t)
    if _FLOAT.match(t):
        return _float(t)
    return t


def _strip_comment(line: str) -> str:
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


def _entries(text: str) -> List[Tuple[int, str, str, int]]:
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"line {lineno}: tabs in indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or body == "-":
            raise ValueError(f"line {lineno}: block sequences are not supported")
        key, sep, value = body.partition(":")
        if not sep or (value and not value.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'KEY: value', got {body!r}")
        out.append((indent, key.strip(), value.strip(), lineno))
    return out


def loads(text: str) -> Dict[str, Any]:
    """A YAML document of nested block mappings -> a dict (empty for no entries)."""
    root: Dict[str, Any] = {}
    # open mappings: [indent of their keys (None until the first key), dict,
    # parent dict, key in the parent]; a "KEY:" with no block under it is null
    stack: List[list] = [[None, root, None, None]]

    def close():
        indent, node, parent, key = stack.pop()
        if indent is None and parent is not None:
            parent[key] = None

    for indent, key, value, lineno in _entries(text):
        while True:
            top = stack[-1]
            if top[0] is None:
                outer = stack[-2][0] if len(stack) > 1 else -1
                if indent > outer:
                    top[0] = indent
                    break
                close()
            elif indent == top[0]:
                break
            elif indent < top[0] and len(stack) > 1:
                close()
            else:
                raise ValueError(f"line {lineno}: bad indentation")
        node = stack[-1][1]
        if key in node:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        if value == "":
            node[key] = {}
            stack.append([None, node[key], node, key])
        else:
            node[key] = parse_scalar(value)
    while len(stack) > 1:
        close()
    return root


def load_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())
