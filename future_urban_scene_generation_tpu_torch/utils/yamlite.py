"""A reader for the small YAML subset of the reference's configuration files.

The port does not depend on PyYAML, and three files on the serving path are YAML:
EdgeConnect's ``checkpoints/inpainting/config.yml`` (flat ``KEY: value`` pairs), the
Mask R-CNN ``checkpoints/maskrcnn/config.yml`` sidecar (the same, with flow lists
such as ``layers: [3, 4, 6, 3]``) and the CAD keypoint files
``pascal_car_cad_NNN.yaml`` (one nested map, ``kpoints_3d: {name: [x, y, z]}``).
This module reads what those files hold, in the layouts a hand or ``yaml.safe_dump``
writes them (``video.parse_calibration_file`` reads the calibration file the same
way):

* block mappings nested by indentation, keys plain or quoted;
* block sequences (``- item`` lines, at the key's indentation or deeper);
* flow sequences and flow mappings of scalars, nested (``[1, [2, 3]]``, ``{a: 1}``);
* scalars: ``null``/``~``, ``true``/``false``, decimal integers, floats (YAML 1.2
  core schema: ``2e6`` and ``1e-4`` are floats, where PyYAML's YAML 1.1 resolver
  keeps an exponent without a dot as a string), plain, single- and double-quoted
  strings;
* ``#`` comments and a leading ``---``.

Anchors, tags, multi-line scalars and multiple documents are refused with a
``ValueError`` that names the line.
"""
from __future__ import annotations

import re
from pathlib import Path

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_SPECIAL = {"null": None, "~": None, "": None, "true": True, "True": True, "TRUE": True,
            "false": False, "False": False, "FALSE": False,
            ".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
            ".nan": float("nan")}
_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0"}


def scalar(text: str):
    """One plain or quoted scalar, resolved to None, bool, int, float or str."""
    text = text.strip()
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"unterminated single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"unterminated double-quoted scalar {text!r}")
        return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(1)), text[1:-1])
    if text[:1] in "&*!|>":
        raise ValueError(f"unsupported YAML construct {text!r}")
    if text in _SPECIAL:
        return _SPECIAL[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (a ``#`` inside quotes stays)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str):
    """The comma-separated items of a flow collection's body, at depth 0."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    tail = body[start:]
    if tail.strip() or items:
        items.append(tail)
    return [item for item in items if item.strip()]


def _key_split(text: str):
    """(key, rest) of ``key: rest``, or None when ``text`` is no mapping entry."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            key = scalar(text[:i])
            return ("" if key is None else key), text[i + 1:].strip()
    return None


def value(text: str):
    """A scalar or a flow collection of them."""
    text = text.strip()
    if text[:1] == "[":
        if text[-1:] != "]":
            raise ValueError(f"unterminated flow sequence {text!r}")
        return [value(item) for item in _split_flow(text[1:-1])]
    if text[:1] == "{":
        if text[-1:] != "}":
            raise ValueError(f"unterminated flow mapping {text!r}")
        out = {}
        for item in _split_flow(text[1:-1]):
            kv = _key_split(item.strip())
            if kv is None:
                raise ValueError(f"flow mapping entry without a key: {item!r}")
            out[kv[0]] = value(kv[1])
        return out
    return scalar(text)


def loads(text: str):
    """Parse ``text``; returns a dict (an empty document gives ``{}``)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab in indentation")
        body = _strip_comment(raw)
        if not body.strip() or (not lines and body.strip() == "---"):
            continue
        lines.append((n, len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return {}
    node, end = _block(lines, 0, lines[0][1])
    if end != len(lines):
        n = lines[end][0]
        raise ValueError(f"line {n}: unexpected indentation")
    return node


def _block(lines, i, indent):
    """The block node whose lines start at ``lines[i]`` with ``indent``; returns
    (node, index of the first line after it)."""
    if lines[i][2].startswith("- ") or lines[i][2] == "-":
        out = []
        while i < len(lines) and lines[i][1] == indent and (
                lines[i][2].startswith("- ") or lines[i][2] == "-"):
            item = lines[i][2][1:].strip()
            if not item:
                raise ValueError(f"line {lines[i][0]}: nested block in a sequence")
            out.append(value(item))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        n, _, body = lines[i]
        kv = _key_split(body)
        if kv is None:
            raise ValueError(f"line {n}: expected 'key: value', got {body!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = value(rest)
        elif i < len(lines) and (lines[i][1] > indent or (
                lines[i][1] == indent and lines[i][2].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def load(path):
    """Parse the file at ``path``."""
    return loads(Path(path).read_text())
