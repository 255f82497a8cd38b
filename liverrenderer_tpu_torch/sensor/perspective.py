"""Sensors: film position -> primary ray (counterpart of
liverrenderer_tpu/sensor/perspective.py) for the seven sensor types:
perspective, thinlens, orthographic, distant, radiancemeter,
irradiancemeter and batch.  x-FOV in degrees, camera-to-world with +z
forward per Mitsuba's look_at; dispatch on the static sensor type.
"""
from __future__ import annotations

import math as pymath

import torch

from ..core import math as m
from ..core import warp
from ..core.types import INF, Ray
from ..scene.ir import (SENSOR_BATCH, SENSOR_DISTANT, SENSOR_IRRADIANCEMETER,
                        SENSOR_ORTHOGRAPHIC, SENSOR_RADIANCEMETER,
                        SENSOR_THINLENS, Scene)

# sensors whose ray takes a second 2-D sample (lens or direction) after the
# film sample
APERTURE_SENSORS = (SENSOR_THINLENS, SENSOR_IRRADIANCEMETER)


def ray_weight(scene: Scene) -> float:
    """Static importance weight of a camera ray: pi for the
    irradiancemeter (its cosine-weighted directions have pdf cos / pi), 1
    for the others."""
    if scene.sensor.stype == SENSOR_IRRADIANCEMETER:
        return pymath.pi
    return 1.0


def _ray(o, d):
    return Ray(o=o, d=d, maxt=torch.full(d.shape[:-1], INF, device=d.device))


def sample_ray(scene: Scene, pos_film, aperture_u=None):
    """pos_film (N,2) continuous pixel coordinates in [0,W)x[0,H);
    aperture_u (N,2): the lens sample of a thinlens, the direction sample
    of an irradiancemeter -> world-space camera rays."""
    sensor = scene.sensor
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    nx = pos_film[..., 0] / w
    ny = pos_film[..., 1] / h
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    shape3 = nx.shape + (3,)

    if sensor.stype == SENSOR_RADIANCEMETER:
        # L(o, d) of to_world's origin and +z for every sample
        d_w = torch.broadcast_to(m.normalize(R[:, 2]), shape3)
        return _ray(torch.broadcast_to(t, shape3), d_w)

    if sensor.stype == SENSOR_DISTANT:
        # radiance arriving along to_world's +z: origins spread over the
        # scene bounding sphere's cross-section (the film maps onto the
        # disk), or above an explicit target point
        d = m.normalize(R[:, 2])
        c, r = sensor.bsphere[:3], sensor.bsphere[3]
        if sensor.has_target:
            o_w = torch.broadcast_to(sensor.target - d * (2.0 * r), shape3)
        else:
            u, v = m.coordinate_system(d)
            disk = warp.square_to_uniform_disk_concentric(
                torch.stack([nx, ny], -1)) * r
            o_w = (c - d * r) + disk[..., 0:1] * u + disk[..., 1:2] * v
        return _ray(o_w, torch.broadcast_to(d, o_w.shape))

    if sensor.stype == SENSOR_IRRADIANCEMETER:
        # a uniform-area position on the parent shape (the film sample),
        # a cosine-weighted outgoing direction (the aperture sample)
        from ..emitter.dispatch import _sample_shape_position
        shape_idx = torch.full(nx.shape, sensor.target_shape,
                               dtype=torch.int64, device=nx.device)
        u2 = torch.stack([nx, ny], -1)
        u_reuse = torch.remainder((nx + ny) * 7919.0 + 0.5, 1.0)
        p, n, _ = _sample_shape_position(scene, shape_idx, u2, u_reuse)
        if aperture_u is None:       # the AOV renders pass no sample
            aperture_u = torch.stack([torch.remainder(nx * 6151.0, 1.0),
                                      torch.remainder(ny * 6151.0, 1.0)],
                                     -1)
        d_local = warp.square_to_cosine_hemisphere(aperture_u)
        fu, fv = m.coordinate_system(n)
        d_w = d_local[..., 0:1] * fu + d_local[..., 1:2] * fv \
            + d_local[..., 2:3] * n
        return _ray(p + n * 1e-4, m.normalize(d_w))

    if sensor.stype == SENSOR_BATCH:
        # the film's width split evenly across the child cameras
        S = sensor.batch_count
        sf = nx * S
        idx = torch.clamp(sf.to(torch.int64), 0, S - 1)
        nx_l = sf - idx
        Rb = sensor.batch_to_world[idx][..., :3, :3]
        tb = sensor.batch_to_world[idx][..., :3, 3]
        sub_aspect = (w / S) / h
        tan_half = torch.tan(torch.deg2rad(sensor.batch_fov_x[idx]) * 0.5)
        dx = (1.0 - 2.0 * nx_l) * tan_half
        dy = (1.0 - 2.0 * ny) * tan_half / sub_aspect
        d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)
        return _ray(tb, m.normalize(torch.einsum("...ij,...j->...i", Rb,
                                                 d_cam)))

    if sensor.stype == SENSOR_ORTHOGRAPHIC:
        # the film maps onto a unit sensor rectangle scaled by to_world
        o_cam = torch.stack([1.0 - 2.0 * nx, (1.0 - 2.0 * ny) / aspect,
                             torch.zeros_like(nx)], -1)
        d_w = torch.broadcast_to(R[:, 2], o_cam.shape)
        return _ray(o_cam @ R.T + t, m.normalize(d_w))

    # image-plane half extents at z = 1 from the x-FOV
    tan_half = torch.tan(torch.deg2rad(sensor.fov_x) * 0.5)
    dx = (1.0 - 2.0 * nx) * tan_half
    dy = (1.0 - 2.0 * ny) * tan_half / aspect
    d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1)

    if sensor.stype == SENSOR_THINLENS and aperture_u is not None:
        # a jittered lens origin aimed at the focus plane's point
        focus = d_cam * (sensor.focus_distance
                         / torch.clamp(d_cam[..., 2:3], min=1e-6))
        disk = warp.square_to_uniform_disk_concentric(aperture_u)
        o_cam = torch.cat([disk * sensor.aperture_radius,
                           torch.zeros_like(disk[..., :1])], -1)
        d_cam = m.normalize(focus - o_cam)
        return _ray(o_cam @ R.T + t, d_cam @ R.T)

    d_w = m.normalize(d_cam) @ R.T
    return _ray(torch.broadcast_to(t, d_w.shape), d_w)
