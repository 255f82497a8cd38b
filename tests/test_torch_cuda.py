"""The CUDA kernel on the card, against its plain PyTorch version.

Marked `cuda`: skips without a CUDA device.  The file imports no JAX (the
machine with the card has none), so it runs there without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import cuda_intersect as tci
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict


@pytest.mark.cuda
def test_kernel_matches_plain_version():
    """Same tensors through the kernel and the plain version: equal hit
    sets and t wherever both take the same triangle (the same fp32
    operations, no FMA contraction; the kernel's chunk culling may only
    drop a grazing hit lying outside its chunk box by a rounding error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = lrt.load_dict(liver_proxy_dict(64, 48, 1, 3, 0), device="cuda")
    rng = np.random.default_rng(0)
    n = 5000
    o = rng.uniform(-0.8, 0.8, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.02, 1.0, n))
    center = scene.tri_center.cpu().numpy()
    rays = np.concatenate([(o - center).T, d.T, maxt[None], np.zeros((1, n))])
    rays = torch.from_numpy(np.ascontiguousarray(rays, np.float32)).cuda()
    before = tci.LAUNCHES
    tk, pk = tci.intersect_closest(rays, scene.tri_buf, scene.tri_boxes)
    tr, pr = tci.intersect_closest_reference(rays, scene.tri_buf,
                                             scene.tri_boxes)
    torch.cuda.synchronize()
    assert tci.LAUNCHES == before + 1
    hit = pr >= 0
    assert hit.sum() > 1000
    assert ((pk >= 0) == hit).float().mean() >= 0.9999
    same = (pk == pr) & hit
    assert same.sum() >= 0.99 * hit.sum()
    torch.testing.assert_close(tk[same], tr[same], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_render_runs_through_kernel():
    """A small render on the card launches the kernel and agrees with the
    CPU render (plain version) pixel for pixel within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = liver_proxy_dict(16, 12, 4, 2, 0)
    ref = lrt.render(lrt.load_dict(d), spp=4).numpy()
    before = tci.LAUNCHES
    img = lrt.render(lrt.load_dict(d, device="cuda"), spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
