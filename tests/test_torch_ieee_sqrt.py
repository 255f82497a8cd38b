"""The port's float32 square roots (liverrenderer_tpu_torch/core/
ieee_sqrt.py): `sqrt` is IEEE's correctly rounded root on the CPU, and no
module of the package takes a root past it (PyTorch's CPU roots come from
MKL's vector math, an ulp off XLA's on some hosts)."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from liverrenderer_tpu_torch.core import ieee_sqrt
from torch_threads import torch_threads_per_worker  # noqa: F401

PKG = Path(ieee_sqrt.__file__).resolve().parent.parent
# the elementwise roots, which PyTorch's CPU build takes from MKL's vector
# math (the norms of torch.linalg are reductions and not held here)
ROOT_CALL = re.compile(r"\btorch\.(sqrt|rsqrt)\(|\.(sqrt|rsqrt)_?\(\)")


def test_no_root_outside_ieee_sqrt():
    """Every elementwise root of the package goes through
    core/ieee_sqrt.sqrt."""
    found = []
    for f in sorted(PKG.rglob("*.py")):
        if f == Path(ieee_sqrt.__file__).resolve():
            continue
        for n, line in enumerate(f.read_text().splitlines(), 1):
            if ROOT_CALL.search(line.split("#")[0]):
                found.append(f"{f.relative_to(PKG)}:{n}: {line.strip()}")
    assert not found, "\n".join(found)


def test_sqrt_is_ieee_on_the_cpu():
    """Bit for bit numpy's float32 root (IEEE's) on seeded normals across
    the exponent range, subnormals, zeros, inf and nan; float64 passes
    through as torch.sqrt."""
    rng = np.random.default_rng(25)
    x = np.concatenate([
        (rng.random(65536) * np.exp2(rng.integers(-126, 127, 65536)))
        .astype(np.float32),
        rng.integers(1, 1 << 23, 1024).astype(np.uint32).view(np.float32),
        np.array([0.0, -0.0, np.inf, np.nan, -1.0], np.float32)])
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = ieee_sqrt.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    d = torch.from_numpy(rng.random(256))
    assert torch.equal(ieee_sqrt.sqrt(d), torch.sqrt(d))
