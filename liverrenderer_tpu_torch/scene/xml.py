"""Mitsuba XML scene files -> the builder's dict (counterpart of
liverrenderer_tpu/scene/xml.py), with `<default>` declarations, `$var`
substitution and keyword overrides (the `-D key=value` of the reference's
command line).  Standard-library `xml.etree` and numpy only.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict

import numpy as np

from .transform import Transform

# nested plugins keep their slot's name ("bsdf", "interior", ...), not
# their id
_SLOT_TAGS = ("bsdf", "film", "sampler", "rfilter", "phase", "emitter",
              "medium", "texture", "volume")
_SCALAR_TAGS = {"float": float, "integer": int,
                "boolean": lambda s: s.lower() == "true", "string": str}


def load_file(path: str, device="cuda", variant: str | None = None,
              **overrides):
    """Load a Mitsuba XML scene into the port's Scene on `device` (the
    card unless the caller passes device="cpu").  Keyword arguments
    override the file's `<default>` values; relative file names resolve
    against the file's directory."""
    from .builder import load_dict
    d = parse_xml(path, overrides)
    return load_dict(d, device=device,
                     base_dir=os.path.dirname(os.path.abspath(path)),
                     variant=variant)


def parse_xml(path: str, overrides: Dict[str, Any] | None = None) -> dict:
    """The scene file as the builder's dict."""
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise ValueError(f"{path}: expected a <scene> root, not "
                         f"<{root.tag}>")
    params: Dict[str, str] = {}
    for child in root.findall("default"):
        params[child.attrib["name"]] = child.attrib["value"]
    if overrides:
        params.update({k: str(v) for k, v in overrides.items()})

    def subst(s: str) -> str:
        return re.sub(r"\$(\w+)", lambda mo: params[mo.group(1)], s)

    scene: Dict[str, Any] = {"type": "scene"}
    dup = 0
    for child in root:
        if child.tag == "default":
            continue
        key, val = _convert(child, subst)
        if key in scene:
            dup += 1
            key = f"{key}_{dup}"
        scene[key] = val
    return scene


def _floats(s: str):
    """Numbers separated by commas and/or spaces."""
    return [float(x) for x in re.split(r"[ ,]+", s.strip())]


def _vec3(a: Dict[str, str], default: float):
    return [float(a.get("x", default)), float(a.get("y", default)),
            float(a.get("z", default))]


def _parse_transform(el, subst) -> Transform:
    """A <transform>: its operations applied in order (each new one on the
    left)."""
    t = Transform()
    for op in el:
        a = {k: subst(v) for k, v in op.attrib.items()}
        if op.tag == "translate":
            t = Transform().translate(_vec3(a, 0.0)).matmul(t)
        elif op.tag == "scale":
            if "value" in a:
                v = _floats(a["value"])
                v = v * 3 if len(v) == 1 else v
            else:
                v = _vec3(a, 1.0)
            t = Transform().scale(v).matmul(t)
        elif op.tag == "rotate":
            t = Transform().rotate(_vec3(a, 0.0),
                                   float(a["angle"])).matmul(t)
        elif op.tag == "lookat":
            t = Transform().look_at(_floats(a["origin"]),
                                    _floats(a["target"]),
                                    _floats(a["up"])).matmul(t)
        elif op.tag == "matrix":
            vals = [float(x) for x in a["value"].replace(",", " ").split()]
            t = Transform(np.asarray(vals).reshape(4, 4)).matmul(t)
    return t


def _spectrum(raw: str) -> dict:
    """A <spectrum>: a constant, one "lambda:value" pair (a constant too,
    as in Mitsuba's parser), or "lambda:value, ..." pairs (an irregular
    spectrum, which the builder converts to RGB; the fork's bio media give
    their absorption tables so)."""
    try:
        return {"type": "rgb", "value": [float(raw)] * 3}
    except ValueError:
        pass
    pairs = []
    for tok in re.split(r"[\s,]+", raw.strip()):
        if not tok:
            continue
        lam, sep, v = tok.partition(":")
        try:
            if not sep:
                raise ValueError(tok)
            pairs.append((float(lam), float(v)))
        except ValueError:
            pairs = None
            break
    if pairs and len(pairs) == 1:
        return {"type": "rgb", "value": [pairs[0][1]] * 3}
    if pairs:
        return {"type": "irregular", "wavelengths": [p[0] for p in pairs],
                "values": [p[1] for p in pairs]}
    return {"type": "rgb", "value": [1.0, 1.0, 1.0]}


def _convert(el, subst):
    """An element -> (key, dict or value)."""
    tag = el.tag
    attrib = {k: subst(v) for k, v in el.attrib.items()}
    name = attrib.get("name", attrib.get("id", tag))

    if tag in _SCALAR_TAGS:
        raw = attrib["value"]
        if tag == "float" and ":" in raw:
            raw = raw.split(":")[-1]          # a legacy "lambda:value"
        return name, _SCALAR_TAGS[tag](raw)
    if tag in ("vector", "point"):
        return name, (_floats(attrib["value"]) if "value" in attrib
                      else _vec3(attrib, 0.0))
    if tag == "rgb":
        # legacy Mitsuba 0.6 "lambda:value" tokens keep their value
        v = [float(t.split(":")[-1])
             for t in re.split(r"[ ,]+", attrib["value"].strip()) if t]
        return name, {"type": "rgb", "value": v * 3 if len(v) == 1 else v}
    if tag == "spectrum":
        return name, _spectrum(attrib.get("value", ""))
    if tag == "transform":
        return name, _parse_transform(el, subst)
    if tag == "ref":
        return attrib.get("name", f"ref_{attrib['id']}"), \
            {"type": "ref", "id": attrib["id"]}

    # a plugin: integrator, sensor, film, sampler, bsdf, shape, emitter,
    # medium, phase, texture, rfilter, volume.  The fork's scenes spell a
    # few types with a capital initial ("Dielectric"): lower just the
    # initial (camelCase types like glissonCapsule are canonical)
    t = attrib.get("type", tag)
    d: Dict[str, Any] = {"type": t[:1].lower() + t[1:]}
    if "id" in attrib:
        d["id"] = attrib["id"]
    dup = 0
    for child in el:
        key, val = _convert(child, subst)
        if child.tag in _SLOT_TAGS:
            key = child.attrib.get("name", child.tag)
            if child.tag == "medium" and key not in ("interior", "exterior"):
                key = "interior"
            if child.tag == "rfilter":
                rt = child.attrib["type"]
                val = {"type": rt[:1].lower() + rt[1:]}
        if key in d:
            dup += 1
            key = f"{key}_{dup}"
        d[key] = val
    return attrib.get("id", tag), d
