"""The binned spectral film (counterpart of
liverrenderer_tpu/integrators/spectral.py; the reference's `specfilm`,
which only spectral variants have): a per-pixel radiance image over
wavelength bins, for a spectral-variant scene on the surface path.

Estimator: each lane carries N_SPEC hero wavelengths with the uniform pdf
1 / span; the integral of the radiance over bin b is estimated by
(span / (spp * N_SPEC)) * the sum of the L_i whose lambda_i lies in b.
"""
from __future__ import annotations

import torch

from ..core import spectrum as spec
from ..core.rng import make_sampler
from ..scene.ir import Scene
from ..sensor.perspective import sample_ray
from . import path as path_mod

# lanes per pass: the spp axis is split into passes of at most this many
# lanes, as in the JAX package (its passes bound one device execution)
MAX_SPEC_WAVEFRONT = 1 << 20


@torch.no_grad()
def render_specfilm(scene: Scene, n_bins: int = 16, spp: int = 16,
                    seed: int = 0):
    """(h, w, n_bins) binned spectral radiance over [SPEC_MIN, SPEC_MAX)
    on scene.device: a scene loaded with variant="spectral", walked by
    the surface path's bounce, the wavelength axis binned by box.  The
    counter RNG keys on the global (pixel, sample) pair, so any split of
    the spp axis into passes walks the unsplit render's paths."""
    if not scene.spectral:
        raise ValueError("render_specfilm needs a scene of the spectral "
                         "variant (load_dict(..., variant='spectral'))")
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    spp_pass = max(1, min(spp, MAX_SPEC_WAVEFRONT // max(n_pix, 1)))
    while spp % spp_pass != 0:
        spp_pass -= 1
    acc = torch.zeros((n_pix, n_bins), device=scene.device)
    for p in range(spp // spp_pass):
        acc += _specfilm_pass(scene, seed, p * spp_pass, n_bins, spp,
                              spp_pass)
    return (acc / (spp * spec.N_SPEC)).view(h, w, n_bins)


def _specfilm_pass(scene: Scene, seed, samp0: int, n_bins: int, spp: int,
                   spp_pass: int):
    """Unnormalised (n_pix, n_bins) accumulator over the samples
    [samp0, samp0 + spp_pass) of each pixel."""
    w, h = scene.film_w, scene.film_h
    n_pix = w * h
    lane = torch.arange(n_pix * spp_pass, device=scene.device)
    pix = lane // spp_pass
    samp = lane % spp_pass + samp0
    sampler = make_sampler(pix, samp, seed, kind=scene.sampler_kind,
                           spp=spp)
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    uf, sampler = sampler.next_2d()
    pos = torch.stack([px, py], -1) + uf
    st = path_mod.init_state(sample_ray(scene, pos), sampler, scene)
    for _ in range(scene.max_depth):
        if not bool(st.active.any()):          # one host sync per bounce
            break
        st = path_mod.bounce(scene, st)

    span = spec.SPEC_MAX - spec.SPEC_MIN
    bins = torch.clamp(((st.lam - spec.SPEC_MIN) / span * n_bins)
                       .to(torch.int64), 0, n_bins - 1)
    ipix = torch.clamp(pos[:, 1].to(torch.int64), 0, h - 1) * w \
        + torch.clamp(pos[:, 0].to(torch.int64), 0, w - 1)
    L = torch.where(torch.isfinite(st.L), st.L, 0.0)
    film = torch.zeros(n_pix * n_bins, device=scene.device)
    idx = ipix[:, None] * n_bins + bins                  # (N, N_SPEC)
    film.index_add_(0, idx.reshape(-1), (L * span).reshape(-1))
    return film.view(n_pix, n_bins)
