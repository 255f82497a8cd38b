"""A procedural liver-sized scene for the primal biovolpath slice.

It stands in for the Liver-SingleMesh scene, whose mesh, bitmap and envmap
files are not in the repository: an elongated, smoothly dented ellipsoid of
liver-mesh size (5,120 triangles at subdiv=4; the liver meshes hold 2.4k to
4.8k), a dielectric boundary (IOR 1.38) around the layered liver medium,
under a constant white environment, rendered by biovolpath at depth 12.

Plain numpy: the dict loads into both liverrenderer_tpu.load_dict and
liverrenderer_tpu_torch.load_dict, with `to_world` as a 4x4 array.
"""
from __future__ import annotations

import numpy as np

from . import geometry as geo
from .transform import Transform

# semi-axes of the ellipsoid before the radial displacement
_AXES = np.array([1.5, 0.9, 0.75])


def liver_medium() -> dict:
    """The liver medium's coefficients (style of Liver-SingleMesh's
    scene.xml; the same values as the JAX package's bio volpath tests)."""
    d = {"type": "liver", "scale": 1.0}
    for i, (c, e) in enumerate([(3.0, 0.1), (2.7, 0.4), (0.003, 0.5),
                                (0.023, 0.2)], start=1):
        for ch, f in zip("RGB", (1.0, 0.7, 0.5)):
            d[f"sigma_collagen{i}_{ch}"] = c * f
            d[f"sigma_elastin{i}_{ch}"] = e * f
    d["sigma_blood"] = {"type": "rgb", "value": [0.005, 0.2, 0.25]}
    d["sigma_bile"] = {"type": "rgb", "value": [0.002, 0.003, 0.025]}
    d["sigma_lipid_water"] = {"type": "rgb", "value": [0.005, 0.0005, 0.001]}
    d["sigma_hepatocity"] = 269.0
    return d


def liver_mesh(subdiv: int, seed: int):
    """(vertices, faces, normals, uvs) of the dented ellipsoid: an icosphere
    (20 * 4^subdiv triangles) scaled to _AXES and displaced radially by a
    smooth seeded field of about +-15 %, with recomputed vertex normals."""
    sph = geo.sphere_mesh(subdiv)
    u = sph.vertices.astype(np.float64)             # unit directions
    rng = np.random.default_rng(seed)
    # a few low-frequency plane waves over the sphere
    k = rng.normal(size=(6, 3)) * 1.6
    phase = rng.uniform(0.0, 2.0 * np.pi, 6)
    amp = rng.uniform(0.5, 1.0, 6)
    field = (amp * np.sin(u @ k.T + phase)).sum(-1)
    field = 0.15 * field / np.abs(field).max()
    v = u * _AXES * (1.0 + field)[:, None]
    v = v.astype(np.float32)
    normals = geo.compute_vertex_normals(v, sph.faces)
    return v, sph.faces, normals, sph.uvs


def liver_proxy_dict(width: int, height: int, spp: int, subdiv: int = 4,
                     seed: int = 0) -> dict:
    """The slice's scene dict at the given film size and sample count."""
    v, f, n, uv = liver_mesh(subdiv, seed)
    cam = Transform().look_at([0.0, 0.8, 5.0], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0])
    return {
        "type": "scene",
        "integrator": {"type": "biovolpath", "max_depth": 12},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": cam.matrix.copy(),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "liver_med": liver_medium(),
        "liver": {"type": "mesh", "vertices": v, "faces": f, "normals": n,
                  "uvs": uv,
                  "bsdf": {"type": "dielectric", "int_ior": 1.38,
                           "ext_ior": 1.0},
                  "interior": {"type": "ref", "id": "liver_med"}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}},
    }
