"""Inputs of the subsurface tests, numpy and the port only (no JAX:
chip_smoke.py and tests/test_torch_cuda.py load this module too): seeded
synthetic weights for the learned BSSRDF in the reference's file format,
and the small subsurface sphere scenes.

The reference's trained model is not in the repository.  The synthetic
model has its published widths (23 -> 64 -> 64 -> 64 shared features, a
64 -> 32 -> 1 absorption head, a 68 -> 64 -> 64 -> 64 -> 3 decoder), He-
scaled normal weights, and feature statistics of the shipped model's keys
(mlsPolyLS3, effAlbedo, g), so both packages' readers, the VAE and the SSS
event run as they would on the real files.  Its absorption head's bias is
-1 (absorption ~0.2-0.4) and the decoder's output stays ~1 kernel epsilon
from the entry point.

    model_dir, stats = write_model(tmpdir, seed=0)
    with substituted(model_dir, stats, port_vae_module, jax_vae_module):
        scene = load_dict(d)   # the builders find and read that model
"""
from __future__ import annotations

import contextlib
import functools
import json
import os

import numpy as np

from liverrenderer_tpu_torch.scene import geometry as _geo
from liverrenderer_tpu_torch.scene.transform import Transform

# (file, (out, in)) of every matrix; each has a "_biases"/"_bias" twin
_MATRICES = {
    "shared_preproc_mlp_2_shapemlp_fcn_0": (64, 23),
    "shared_preproc_mlp_2_shapemlp_fcn_1": (64, 64),
    "shared_preproc_mlp_2_shapemlp_fcn_2": (64, 64),
    "absorption_mlp_fcn_0": (32, 64),
    "absorption_dense": (1, 32),
    "scatter_decoder_fcn_fcn_0": (64, 68),
    "scatter_decoder_fcn_fcn_1": (64, 64),
    "scatter_decoder_fcn_fcn_2": (64, 64),
    "scatter_dense_2": (3, 64),
}


def write_bin(path: str, a: np.ndarray):
    """int32 ndims, int32 dims[ndims], float32 data."""
    a = np.asarray(a, np.float32)
    with open(path, "wb") as f:
        np.asarray([a.ndim], np.int32).tofile(f)
        np.asarray(a.shape, np.int32).tofile(f)
        a.tofile(f)


def write_model(root: str, seed: int = 0):
    """Write the model under root -> (model_dir, stats_path)."""
    rng = np.random.default_rng(seed)
    model_dir = os.path.join(root, "model")
    var = os.path.join(model_dir, "variables")
    os.makedirs(var, exist_ok=True)
    for name, (n_out, n_in) in _MATRICES.items():
        w = rng.normal(size=(n_out, n_in)) * np.sqrt(2.0 / n_in)
        b = rng.normal(size=n_out) * 0.05
        if name == "scatter_dense_2":
            w *= 0.5
        if name == "absorption_dense":
            b[:] = -1.0
        dense = name.endswith("dense") or name.endswith("dense_2")
        write_bin(os.path.join(var, name + ("_kernel.bin" if dense
                                             else "_weights.bin")), w)
        write_bin(os.path.join(var, name + ("_bias.bin" if dense
                                             else "_biases.bin")), b)
    stats = {"mlsPolyLS3_mean": (rng.normal(size=20) * 0.1).tolist(),
             "mlsPolyLS3_stdinv": rng.uniform(0.5, 1.5, 20).tolist(),
             # the world-space key the reference hardcodes: never read
             "mlsPoly3_mean": [9.0] * 20, "mlsPoly3_stdinv": [9.0] * 20,
             "effAlbedo_mean": [0.5], "effAlbedo_stdinv": [3.0],
             "g_mean": [0.1], "g_stdinv": [2.0]}
    stats_path = os.path.join(root, "data_stats.json")
    with open(stats_path, "w") as f:
        json.dump(stats, f)
    with open(os.path.join(model_dir, "training-metadata.json"), "w") as f:
        json.dump({"config0": {"shape_features_name": "mlsPolyLS3"}}, f)
    return model_dir, stats_path


@contextlib.contextmanager
def substituted(model_dir: str, stats_path: str, *vae_modules):
    """Point each package's `model_available` / `load_model` (the module
    attributes its builder calls) at the written model, and restore
    them."""
    saved = [(mod, mod.model_available, mod.load_model)
             for mod in vae_modules]
    try:
        for mod, avail, load in saved:
            mod.model_available = functools.partial(avail, model_dir)
            mod.load_model = functools.partial(load, model_dir, stats_path)
        yield
    finally:
        for mod, avail, load in saved:
            mod.model_available, mod.load_model = avail, load


def sphere(subdiv=2, radius=1.0):
    """(vertices, faces) of an icosphere mesh."""
    m = _geo.sphere_mesh(subdiv)
    return (m.vertices * radius).astype(np.float32), m.faces


def sphere_dict(kind, res=16, depth=6, extra=None, rfilter="box",
                sigma_t=(0.8, 1.0, 1.4)):
    """A mesh sphere (icosphere, subdiv 3) with a subsurface ("vaescatter"
    or "dipole"), lit by a point light and a dim constant environment
    (the JAX package's tests/test_ssub.py smoke scenes)."""
    v, f = sphere(3)
    sub = {"vaescatter": {"type": "vaescatter",
                          "sigmaT": {"type": "rgb", "value": list(sigma_t)},
                          "albedo": {"type": "rgb",
                                     "value": [0.99, 0.98, 0.95]}},
           "dipole": {"type": "dipole",
                      "sigmaS": {"type": "rgb", "value": [2.0, 2.3, 3.0]},
                      "sigmaA": {"type": "rgb",
                                 "value": [0.03, 0.1, 0.3]}}}[kind]
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": depth},
         "sensor": {"type": "perspective", "fov": 40.0,
                    "to_world": Transform().look_at(
                        [0, 0, 4], [0, 0, 0], [0, 1, 0]).matrix,
                    "film": {"type": "hdrfilm", "width": res, "height": res,
                             "rfilter": {"type": rfilter}}},
         "blob": {"type": "mesh", "vertices": v, "faces": f,
                  "subsurface": sub},
         "lamp": {"type": "point", "position": [3.0, 3.0, 3.0],
                  "intensity": {"type": "rgb", "value": [40.0] * 3}},
         "env": {"type": "constant",
                 "radiance": {"type": "rgb", "value": [0.1] * 3}}}
    d.update(extra or {})
    return d


# an open vaescatter sheet beside the sphere: a zero-scatter ray through
# it finds no exit (the event's dead lanes)
SHEET = {"sheet": {"type": "rectangle",
                   "to_world": Transform().translate([1.6, 0.0, 0.0]).matrix,
                   "subsurface": {"type": "vaescatter",
                                  "sigmaT": {"type": "rgb",
                                             "value": [2.0, 2.0, 2.0]},
                                  "albedo": {"type": "rgb",
                                             "value": [0.9, 0.9, 0.9]}}}}


def event_rays(n: int, seed: int = 4):
    """(origins, directions) (n, 3) float32: rays from the spheres' camera
    toward random points of the sphere and of SHEET, for one
    subsurface_event on fixed lanes."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32) \
        * np.float32([2.3, 1.1, 0.2])
    o = np.tile(np.float32([[0.0, 0.0, 4.0]]), (n, 1))
    d = tgt - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)
