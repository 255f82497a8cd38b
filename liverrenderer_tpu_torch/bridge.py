"""Scene state crossing between the JAX package and the port, as numpy.

`scene_from_numpy` builds the port's Scene from arrays keyed by the JAX
Scene's dotted field paths ("media.params", "tri_buf", ...) and a dict of
its static fields under the same keys.  `numpy_tree` produces that pair
from any tree of dataclasses whose leaves turn into numpy arrays: the JAX
Scene (flax struct dataclasses of JAX arrays) as well as the port's own.
The port never sees a JAX object: a caller that holds one calls
`numpy_tree` on it, which reads each leaf through `np.asarray`.
`params_from_numpy` does the same for a dict of differentiable parameters
(`render_grad`'s `params`).  The subsurface table's VAE crosses as its
VAEWeights fields under `ssub.weights.*` (matrices (in, out)), from which
`scene_from_numpy` builds the port's `ssub.vae.VAE` module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene.ir import TABLES, Scene
from .ssub.vae import numpy_from_vae, vae_from_numpy


def numpy_tree(obj, prefix: str = ""):
    """(arrays, statics): every leaf of a dataclass tree under its dotted
    path.  A field is static when its metadata says it is not a pytree
    node (flax `static_field`) or when it holds a plain Python value."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if v is None:
            continue
        if isinstance(v, torch.nn.Module):     # the port's VAE
            arrays.update({f"{key}.{k}": a
                           for k, a in numpy_from_vae(v).items()})
        elif dataclasses.is_dataclass(v):
            a, s = numpy_tree(v, key + ".")
            arrays.update(a)
            statics.update(s)
        elif (f.metadata.get("pytree_node", True) is False
              or isinstance(v, (bool, int, float, str, tuple))):
            statics[key] = v
        elif isinstance(v, torch.Tensor):
            arrays[key] = v.detach().cpu().numpy()
        else:
            arrays[key] = np.asarray(v)
    return arrays, statics


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.floating):
        dtype = torch.float32
    else:   # int32/uint32 ids, codes and flags: int64 indexes everywhere
        dtype = torch.int64
        a = a.astype(np.int64)
    # a writable C-ordered copy (0-dim arrays stay 0-dim)
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                        dtype=dtype)


def _build(cls, prefix, arrays, statics, device):
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.type == "Tensor":
            if key not in arrays:
                raise KeyError(f"scene_from_numpy: no array {key!r}")
            kw[f.name] = _tensor(arrays[key], device)
        elif f.type in TABLES:
            kw[f.name] = _build(TABLES[f.type], key + ".", arrays, statics,
                                device)
        elif f.type == "Optional[VAE]":
            # the VAEWeights fields under key, absent when there is none
            sub = {k[len(key) + 1:]: v for k, v in arrays.items()
                   if k.startswith(key + ".")}
            kw[f.name] = vae_from_numpy(sub, device) if sub else None
        elif key in statics:
            v = statics[key]
            kw[f.name] = tuple(int(x) for x in v) if isinstance(v, tuple) \
                else v
    return cls(**kw)


def scene_from_numpy(arrays: dict, statics: dict, device) -> Scene:
    """Port Scene on `device` from numpy arrays and statics keyed by the
    JAX Scene's dotted field paths.  Keys the port does not read are
    ignored; a missing array raises KeyError, a missing static keeps the
    field's default."""
    return _build(Scene, "", arrays, statics, device)


def params_from_numpy(arrays: dict, device) -> dict:
    """The port's params dict on `device` from a parameter dict whose
    values were read out as numpy (`np.asarray` of each JAX array), under
    the same util.traverse keys."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in arrays.items()}
