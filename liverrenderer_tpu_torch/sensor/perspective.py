"""Camera ray generation (counterpart of
liverrenderer_tpu/sensor/perspective.py) for the perspective sensor: x-FOV
in degrees, camera-to-world with +z forward per Mitsuba's look_at."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.types import INF, Ray
from ..errors import not_ported
from ..scene.ir import SENSOR_PERSPECTIVE, Scene


def ray_weight(scene: Scene) -> float:
    """Static importance weight of a camera ray (1 for perspective)."""
    return 1.0


def sample_ray(scene: Scene, pos_film, aperture_u=None):
    """pos_film (N,2) continuous pixel coordinates in [0,W)x[0,H) ->
    world-space camera rays."""
    sensor = scene.sensor
    if sensor.stype != SENSOR_PERSPECTIVE:
        raise not_ported(f"sensor type {sensor.stype}", "Queue 1 M10")
    w, h = scene.film_w, scene.film_h
    aspect = w / h
    nx = pos_film[..., 0] / w
    ny = pos_film[..., 1] / h
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    tan_half = torch.tan(torch.deg2rad(sensor.fov_x) * 0.5)
    dx = (1.0 - 2.0 * nx) * tan_half
    dy = (1.0 - 2.0 * ny) * tan_half / aspect
    d_cam = m.normalize(torch.stack([dx, dy, torch.ones_like(dx)], -1))
    d_w = d_cam @ R.T
    o_w = torch.broadcast_to(t, d_w.shape)
    return Ray(o=o_w, d=d_w, maxt=torch.full(d_w.shape[:-1], INF,
                                             device=d_w.device))
