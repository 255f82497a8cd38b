"""liverrenderer_tpu_torch: the PyTorch/CUDA port of liverrenderer_tpu.

The port follows ROADMAP.md slice by slice; liverrenderer_tpu (JAX) stays
the reference.  Plain tensor code is PyTorch; the closest-hit intersection,
the JAX package's only Pallas kernels, is a hand-written CUDA kernel for
Hopper (csrc/intersect.cu).  The port loads Mitsuba XML scenes with their
mesh (OBJ, PLY, serialized) and image (PNG, EXR, PFM) files, renders the
biovolpath liver path (bump and normal maps, bitmap textures, the envmap,
next-event estimation) and the surface path family, with subsurface
scattering (the learned vaescatter BSSRDF and the classical dipole), on
the regenerating wavefront, in RGB or the spectral variant
(hero-wavelength packets), and differentiates them through the PRB replay
adjoint or the scan adjoint; also the light tracer (`ptracer`), polarized
transport (`stokes`, RGB and spectral) and the radiance field over
Gaussian-splat ellipsoids (`volprim_rf_basic`).

    import liverrenderer_tpu_torch as lrt
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
    scene = lrt.load_dict(liver_proxy_dict(428, 240, 64))  # on the card
    img = lrt.render(scene, spp=64, seed=0)      # (h, w, 3) on the card
    loss, grads, img = lrt.render_grad(
        scene, {"media.params": scene.media.params}, lambda im: im.mean(),
        spp=16, seed=0)                          # grads["media.params"]
    cpu = lrt.load_dict(liver_proxy_dict(16, 12, 4), device="cpu")
    # bench.py's workload path: a height map on the liver and a sky
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, SKY
    bumped = lrt.load_dict(liver_proxy_dict(428, 240, 64, bump=BUMP,
                                            sky=SKY))
    # a Mitsuba XML scene with its mesh, bitmap and envmap files
    scene = lrt.load_file("scene.xml", spp=16)      # <default> overrides
    # a render that can be cancelled, timed out and followed
    ctl = lrt.RenderControl(timeout=60.0, on_progress=print)
    img = lrt.render(scene, control=ctl)            # ctl.frame(): partial
    aovs = lrt.render_aovs(scene, ("depth", "albedo"))
    # the spectral variant: hero-wavelength packets, CIE estimate to RGB
    sp = lrt.load_dict(liver_proxy_dict(428, 240, 64), variant="spectral")
    img = lrt.render(sp)                         # also render_grad
    box = lrt.load_dict(lrt.cornell_box(), variant="spectral")
    bins = lrt.render_specfilm(box, n_bins=16, spp=16)   # (h, w, 16)
    # the light tracer, polarized transport, the splat radiance field
    rgb_box = lrt.load_dict(lrt.cornell_box())
    img = lrt.render_ptracer(rgb_box, spp=64)    # (h, w, 3)
    S = lrt.render_stokes(polarized_scene, spp=16)   # (h, w, 4, 3)
    img = lrt.render(splat_scene)                # also render_grad of
                                                 # volprims.opacity / .sh

The command-line renderer: `python -m liverrenderer_tpu_torch.cli
scene.xml -o out.exr` (on the card; `--cpu` renders on the CPU).  The
fork's liver pipeline: `python -m liverrenderer_tpu_torch.pipeline.driver
settings.yml` (tissue fractions -> the media's coefficients -> render),
`python -m liverrenderer_tpu_torch.pipeline.evaluate` (RMSE and SSIM
against goldens) and `python -m liverrenderer_tpu_torch.denoise scene.xml`
(the a-trous denoiser), each with `--cpu`; for inverse rendering
`LargeSteps` and `checkpoint.OptimizationCheckpointer`.
"""

import torch as _torch

# Geometry math must be true fp32, as the JAX package forces "highest"
# matmul precision: TF32 camera-ray directions would shift silhouettes.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .scene.builder import load_dict  # noqa: E402
from .scene.cornell import cornell_box  # noqa: E402
from .scene.xml import load_file  # noqa: E402
from .scene.transform import Transform  # noqa: E402
from .io.image import read_image, write_image  # noqa: E402
from .integrators.common import render  # noqa: E402
from .integrators.regen import RenderControl  # noqa: E402
from .integrators.prb import render_fwd_grad, render_grad  # noqa: E402
from .integrators.aux import (render_aovs, render_depth,  # noqa: E402
                              render_direct, render_moments)
from .integrators.spectral import render_specfilm  # noqa: E402
from .integrators.ptracer import render_ptracer  # noqa: E402
from .integrators.stokes import render_stokes  # noqa: E402
from .util import SceneParameters, apply_params, traverse  # noqa: E402
from .largesteps import LargeSteps  # noqa: E402

__all__ = ["load_dict", "load_file", "cornell_box", "read_image",
           "write_image", "render", "RenderControl", "render_grad",
           "render_fwd_grad", "render_aovs", "render_depth", "render_direct",
           "render_moments", "render_specfilm", "render_ptracer",
           "render_stokes", "traverse", "apply_params",
           "SceneParameters", "Transform", "LargeSteps"]
