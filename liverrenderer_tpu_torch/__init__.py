"""liverrenderer_tpu_torch: the PyTorch/CUDA port of liverrenderer_tpu.

The port follows ROADMAP.md slice by slice; liverrenderer_tpu (JAX) stays
the reference.  Plain tensor code is PyTorch; the closest-hit intersection,
the JAX package's only Pallas kernels, is a hand-written CUDA kernel for
Hopper (csrc/intersect.cu).  The first slice renders the primal biovolpath
path: load a scene dict, render it on the regenerating wavefront.

    import liverrenderer_tpu_torch as lrt
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
    scene = lrt.load_dict(liver_proxy_dict(428, 240, 64), device="cuda")
    img = lrt.render(scene, spp=64, seed=0)      # (h, w, 3) on the card
"""

import torch as _torch

# Geometry math must be true fp32, as the JAX package forces "highest"
# matmul precision: TF32 camera-ray directions would shift silhouettes.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .scene.builder import load_dict  # noqa: E402
from .scene.transform import Transform  # noqa: E402
from .integrators.common import render  # noqa: E402

__all__ = ["load_dict", "render", "Transform"]
