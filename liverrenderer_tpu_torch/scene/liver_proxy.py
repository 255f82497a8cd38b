"""A procedural liver-sized scene for the biovolpath slices.

It stands in for the Liver-SingleMesh scene, whose mesh, bitmap and envmap
files are not in the repository: an elongated, smoothly dented ellipsoid of
liver-mesh size (5,120 triangles at subdiv=4; the liver meshes hold 2.4k to
4.8k), a dielectric boundary (IOR 1.38) around the layered liver medium,
under a constant white environment, rendered by biovolpath at depth 12.
Two options put bench.py's workload path through it: `bump` wraps the
dielectric in a bumpmap whose height map is a seeded field on the mesh's
uvs, and `sky` replaces the constant environment with a lat-long envmap of
a synthetic sky.  Both images are inline numpy data, so no file is read.

`sss_liver_dict` puts the same mesh under the surface path family with a
subsurface BSSRDF instead of the medium: the learned `vaescatter` or the
classical `dipole`, lit by a point light and the synthetic sky.

Plain numpy: the dicts load into both liverrenderer_tpu.load_dict and
liverrenderer_tpu_torch.load_dict, with `to_world` as a 4x4 array.
"""
from __future__ import annotations

import numpy as np

from . import geometry as geo
from .transform import Transform

# semi-axes of the ellipsoid before the radial displacement
_AXES = np.array([1.5, 0.9, 0.75])

# full-size options (bench.py's workload): a 1,024 x 1,024 height map at
# scale 0.05, whose perturbed normals tilt by 11 degrees at the median and
# 27 at most (21 at the 90th percentile), and a 1,024 x 512 sky
BUMP = (1024, 0.05)
SKY = (1024, 512)


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


def height_map(res: int, seed: int) -> np.ndarray:
    """(res, res) float32 height field in [0, 1] over uv (rows v, columns
    u, sampled at texel centres): six seeded plane waves of integer
    frequencies 1-4 in u and 1-3 in v, so it wraps without a seam."""
    rng = np.random.default_rng(seed + 1)
    a = rng.integers(1, 5, 6)
    b = rng.integers(1, 4, 6)
    phase = rng.uniform(0.0, 2.0 * np.pi, 6)
    amp = rng.uniform(0.5, 1.0, 6)
    c = (np.arange(res) + 0.5) / res
    u, v = np.meshgrid(c, c)
    f = (amp * np.sin(2.0 * np.pi * (u[..., None] * a + v[..., None] * b)
                      + phase)).sum(-1)
    return ((f - f.min()) / (f.max() - f.min())).astype(np.float32)


def sky_map(w: int, h: int) -> np.ndarray:
    """(h, w, 3) float32 lat-long sky in the envmap's convention (rows
    theta from +y down, columns phi = atan2(x, -z)): a horizon-to-zenith
    gradient above a dim ground, and one sun lobe (peak ~20, ~5 degrees
    wide) at 35 degrees elevation.  Every value is > 0."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    d = np.stack(np.broadcast_arrays(st * np.sin(phi)[None], ct,
                                     -st * np.cos(phi)[None]), -1)
    up = np.clip(ct, 0.0, 1.0)[..., None]
    horizon = np.array([1.0, 0.95, 0.85])
    sky = horizon + (np.array([0.35, 0.55, 1.0]) - horizon) * np.sqrt(up)
    down = np.clip(-ct * 4.0, 0.0, 1.0)[..., None]
    sky = sky + (np.array([0.35, 0.3, 0.25]) - sky) * down
    el, az = np.deg2rad(35.0), 0.8
    sun = np.array([np.cos(el) * np.sin(az), np.sin(el),
                    -np.cos(el) * np.cos(az)])
    lobe = 20.0 * np.exp((d @ sun - 1.0) / 0.004)
    return (sky + lobe[..., None] * np.array([1.0, 0.9, 0.75])) \
        .astype(np.float32)


def liver_proxy_dict(width: int, height: int, spp: int, subdiv: int = 4,
                     seed: int = 0, bump=None, sky=None) -> dict:
    """The slices' scene dict at the given film size and sample count.
    bump=(res, scale): a res x res height map on the liver's dielectric;
    sky=(w, h): a w x h lat-long sky instead of the constant environment
    (BUMP and SKY are the full-size values)."""
    v, f, n, uv = liver_mesh(subdiv, seed)
    cam = Transform().look_at([0.0, 0.8, 5.0], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0])
    bsdf = {"type": "dielectric", "int_ior": 1.38, "ext_ior": 1.0}
    if bump is not None:
        bsdf = {"type": "bumpmap", "scale": float(bump[1]),
                "texture": {"type": "bitmap",
                            "data": height_map(int(bump[0]), seed)},
                "bsdf": bsdf}
    env = {"type": "constant",
           "radiance": {"type": "rgb", "value": [1.0, 1.0, 1.0]}}
    if sky is not None:
        env = {"type": "envmap", "data": sky_map(int(sky[0]), int(sky[1]))}
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
                  "bsdf": bsdf,
                  "interior": {"type": "ref", "id": "liver_med"}},
        "env": env,
    }


# the subsurface proxy's medium: mean free paths 1 / sigma_t of 0.125,
# 0.1 and 0.071, 3.1 %, 2.5 % and 1.8 % of the mesh's ~4.0 bounding-box
# diagonal (3.2 x 1.8 x 1.6), so light diffuses a few triangles wide
# (edges ~0.1 at subdiv 4) and the polynomial fits' kernel (sqrt(eps) ~
# 0.15) spans local curvature; a reddish tissue-like albedo
SSS_SIGMA_T = (8.0, 10.0, 14.0)
SSS_ALBEDO = (0.99, 0.97, 0.93)
SSS_ETA = 1.38
SSS_POINT = {"type": "point", "position": [1.5, 3.0, 3.0],
             "intensity": {"type": "rgb", "value": [15.0, 15.0, 15.0]}}


def sss_liver_dict(width: int, height: int, spp: int, kind="vae",
                   subdiv: int = 4, seed: int = 0, sky=SKY,
                   max_depth: int = 12) -> dict:
    """The liver mesh with a subsurface BSSRDF under `path`, in the style
    of the fork's learned-SSS golden scene (tent filter, ldsampler) lit by
    a point light and an envmap of the synthetic sky.  kind: "vae" (a
    vaescatter), "dipole", or None (its internal dielectric alone,
    int_ior = eta: the same scene without the subsurface)."""
    v, f, n, uv = liver_mesh(subdiv, seed)
    cam = Transform().look_at([0.0, 0.8, 5.0], [0.0, 0.0, 0.0],
                              [0.0, 1.0, 0.0])
    liver = {"type": "mesh", "vertices": v, "faces": f, "normals": n,
             "uvs": uv}
    if kind is None:
        liver["bsdf"] = {"type": "dielectric", "int_ior": SSS_ETA,
                         "ext_ior": 1.0}
    else:
        liver["subsurface"] = {
            "type": {"vae": "vaescatter", "dipole": "dipole"}[kind],
            "sigmaT": {"type": "rgb", "value": list(SSS_SIGMA_T)},
            "albedo": {"type": "rgb", "value": list(SSS_ALBEDO)},
            "eta": SSS_ETA}
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {
            "type": "perspective", "fov": 45.0,
            "to_world": cam.matrix.copy(),
            "film": {"type": "hdrfilm", "width": width, "height": height,
                     "rfilter": {"type": "tent"}},
            "sampler": {"type": "ldsampler", "sample_count": spp},
        },
        "liver": liver,
        "sun": dict(SSS_POINT),
        "env": {"type": "envmap", "data": sky_map(int(sky[0]),
                                                  int(sky[1]))},
    }
