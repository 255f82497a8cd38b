"""The port's square root.  Every float32 root of the port goes through
`sqrt` (tests/test_torch_ieee_sqrt.py holds the package to that)."""
from __future__ import annotations

import torch


def sqrt(x):
    """IEEE's correctly rounded square root, as XLA and CUDA compute it.
    PyTorch's CPU build takes the float32 root from MKL's vector math,
    which on some hosts (an AMD EPYC with AVX-512) is one ulp off on about
    a fifth of the inputs; the float64 root of a float32 rounded once to
    float32 is the IEEE result (53 >= 2 * 24 + 2 bits)."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
