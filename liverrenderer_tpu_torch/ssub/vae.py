"""Learned shape-adaptive subsurface scattering: the VAE's inference
(counterpart of liverrenderer_tpu/ssub/vae.py).

The model is the reference's (Vicini et al.), three small MLPs run over the
wavefront as batched products:

  shared preproc MLP : 23 features -> 64 -> 64 -> 64 (ReLU)
  absorption head    : 64 -> 32 (ReLU) -> 1 (sigmoid)
  scatter decoder    : [4 latent, 64 features] -> 64^3 (ReLU) -> 3

Features (preprocessFeatures): the 20 normalised light-space polynomial
coefficients, then the normalised effective albedo (of the g-reduced
albedo), the normalised g and 2 (ior - 1.25).

Weights are read from the reference's files (`int32 ndims, int32
dims[ndims], float32 data`, each matrix stored (out, in)) into a dict of
numpy arrays in the JAX package's `VAEWeights` layout, matrices (in, out):
`load_model` returns that dict, and `vae_from_numpy` turns such a dict
(also the JAX `VAEWeights` read out as numpy) into the `VAE` module.  The
default directories follow the reference repository's layout inside this
checkout; until the shipped weights are added there, `model_available()`
is false and the builders render vaescatter shapes as their internal
dielectric.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..core.math import sqrt
from .poly import effective_albedo

_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_MODEL_DIR = str(
    _ROOT / "pysrc" / "outputs" / "vae3d" / "models"
    / "0487_FinalSharedLs7Mixed3_AbsSharedSimComplexMixed3")
DEFAULT_STATS = str(
    _ROOT / "pysrc" / "outputs" / "vae3d" / "datasets"
    / "0118_ScatterDataMixed3" / "train" / "data_stats.json")

# VAEWeights field -> the reference's file (matrices and their biases)
FILES = {
    "pre_w0": "shared_preproc_mlp_2_shapemlp_fcn_0_weights.bin",
    "pre_b0": "shared_preproc_mlp_2_shapemlp_fcn_0_biases.bin",
    "pre_w1": "shared_preproc_mlp_2_shapemlp_fcn_1_weights.bin",
    "pre_b1": "shared_preproc_mlp_2_shapemlp_fcn_1_biases.bin",
    "pre_w2": "shared_preproc_mlp_2_shapemlp_fcn_2_weights.bin",
    "pre_b2": "shared_preproc_mlp_2_shapemlp_fcn_2_biases.bin",
    "abs_w0": "absorption_mlp_fcn_0_weights.bin",
    "abs_b0": "absorption_mlp_fcn_0_biases.bin",
    "abs_w1": "absorption_dense_kernel.bin",
    "abs_b1": "absorption_dense_bias.bin",
    "dec_w0": "scatter_decoder_fcn_fcn_0_weights.bin",
    "dec_b0": "scatter_decoder_fcn_fcn_0_biases.bin",
    "dec_w1": "scatter_decoder_fcn_fcn_1_weights.bin",
    "dec_b1": "scatter_decoder_fcn_fcn_1_biases.bin",
    "dec_w2": "scatter_decoder_fcn_fcn_2_weights.bin",
    "dec_b2": "scatter_decoder_fcn_fcn_2_biases.bin",
    "out_w": "scatter_dense_2_kernel.bin",
    "out_b": "scatter_dense_2_bias.bin",
}
# the module's layers and the fields of their (in, out) matrices
_LAYERS = {"pre0": "pre_w0", "pre1": "pre_w1", "pre2": "pre_w2",
           "abs0": "abs_w0", "abs1": "abs_w1", "dec0": "dec_w0",
           "dec1": "dec_w1", "dec2": "dec_w2", "out": "out_w"}
_STATS = ("feat_mean", "feat_stdinv", "albedo_mean", "albedo_stdinv",
          "g_mean", "g_stdinv")


def load_bin(path: str) -> np.ndarray:
    """A reference weight file: int32 ndims, int32 dims[ndims], f32 data."""
    with open(path, "rb") as f:
        ndims = np.fromfile(f, np.int32, 1)[0]
        dims = np.fromfile(f, np.int32, ndims)
        data = np.fromfile(f, np.float32, int(np.prod(dims)))
    return data.reshape(dims)


def load_model(model_dir: str = DEFAULT_MODEL_DIR,
               stats_path: str = DEFAULT_STATS) -> dict:
    """The model's tensors as numpy, in the JAX VAEWeights layout.

    The polynomial features are normalised with the statistics the model
    was trained with: training-metadata.json's shape_features_name
    ("mlsPolyLS3", light space, for the shipped model), as the JAX package
    reads them (the reference's ScatterModelSimShared hardcodes the
    world-space "mlsPoly3" key)."""
    var = os.path.join(model_dir, "variables")
    out = {}
    for field, name in FILES.items():
        a = load_bin(os.path.join(var, name))
        out[field] = a.T.copy() if "_w" in field else a.reshape(-1)
    with open(stats_path) as f:
        stats = json.load(f)
    key = "mlsPolyLS3"
    meta = os.path.join(model_dir, "training-metadata.json")
    if os.path.exists(meta):
        with open(meta) as f:
            key = json.load(f).get("config0", {}).get(
                "shape_features_name", key)
    out["feat_mean"] = np.asarray(stats[key + "_mean"], np.float32)
    out["feat_stdinv"] = np.asarray(stats[key + "_stdinv"], np.float32)
    for field, name in (("albedo", "effAlbedo"), ("g", "g")):
        out[field + "_mean"] = np.float32(stats[name + "_mean"][0])
        out[field + "_stdinv"] = np.float32(stats[name + "_stdinv"][0])
    return out


def model_available(model_dir: str = DEFAULT_MODEL_DIR) -> bool:
    return os.path.isdir(os.path.join(model_dir, "variables"))


class VAE(nn.Module):
    """The three networks and the feature statistics (buffers).  Inference
    only: no parameter requires grad."""

    def __init__(self):
        super().__init__()
        self.pre0, self.pre1, self.pre2 = (nn.Linear(23, 64),
                                           nn.Linear(64, 64),
                                           nn.Linear(64, 64))
        self.abs0, self.abs1 = nn.Linear(64, 32), nn.Linear(32, 1)
        self.dec0, self.dec1, self.dec2 = (nn.Linear(68, 64),
                                           nn.Linear(64, 64),
                                           nn.Linear(64, 64))
        self.out = nn.Linear(64, 3)
        for name, n in (("feat_mean", 20), ("feat_stdinv", 20)):
            self.register_buffer(name, torch.zeros(n))
        for name in _STATS[2:]:
            self.register_buffer(name, torch.zeros(()))
        self.requires_grad_(False)

    def preprocess_features(self, poly_ls, albedo, g, eta, sigma_t):
        """preprocessFeatures<3, similarity theory>: poly_ls (N, 20)
        light-space coefficients, albedo / sigma_t / g / eta (N,) ->
        (N, 23)."""
        sigma_s = albedo * sigma_t
        sigma_a = sigma_t - sigma_s
        albedo_p = (1.0 - g) * sigma_s / torch.clamp(
            (1.0 - g) * sigma_s + sigma_a, min=1e-12)
        a_n = (effective_albedo(albedo_p) - self.albedo_mean) \
            * self.albedo_stdinv
        g_n = (g - self.g_mean) * self.g_stdinv
        i_n = 2.0 * (eta - 1.25)
        n = poly_ls.shape[0]
        extras = torch.stack([torch.broadcast_to(x, (n,))
                              for x in (a_n, g_n, i_n)], -1)
        return torch.cat([(poly_ls - self.feat_mean) * self.feat_stdinv,
                          extras], -1)

    def shared_features(self, x):
        """(N, 23) -> (N, 64)."""
        h = torch.relu(self.pre0(x))
        h = torch.relu(self.pre1(h))
        return torch.relu(self.pre2(h))

    def absorption_prob(self, feat):
        """(N, 64) -> (N,) absorption probability."""
        return torch.sigmoid(self.abs1(torch.relu(self.abs0(feat)))[..., 0])

    def decode_outpos(self, feat, latent):
        """(N, 64) features and (N, 4) latent -> (N, 3) tangent-space exit
        offset."""
        h = torch.relu(self.dec0(torch.cat([latent, feat], -1)))
        h = torch.relu(self.dec1(h))
        h = torch.relu(self.dec2(h))
        return self.out(h)


def vae_from_numpy(arrays: dict, device) -> VAE:
    """The VAE module on `device` from the JAX VAEWeights fields as numpy
    (matrices (in, out), transposed here to nn.Linear's (out, in))."""
    vae = VAE()
    with torch.no_grad():
        for layer, w in _LAYERS.items():
            lin = getattr(vae, layer)
            lin.weight.copy_(torch.from_numpy(
                np.array(arrays[w], np.float32).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.array(
                arrays[w.replace("_w", "_b")], np.float32).reshape(-1)))
        for name in _STATS:
            getattr(vae, name).copy_(torch.from_numpy(
                np.array(arrays[name], np.float32)))
    return vae.to(device)


def numpy_from_vae(vae: VAE) -> dict:
    """vae_from_numpy's inverse: the JAX VAEWeights fields as numpy."""
    out = {}
    for layer, w in _LAYERS.items():
        lin = getattr(vae, layer)
        out[w] = lin.weight.detach().cpu().numpy().T.copy()
        out[w.replace("_w", "_b")] = lin.bias.detach().cpu().numpy()
    for name in _STATS:
        out[name] = getattr(vae, name).cpu().numpy()
    return out


def gaussian_from_uniform(u1, u2):
    """Box-Muller."""
    r = sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos(2.0 * np.pi * u2), r * torch.sin(2.0 * np.pi * u2)
