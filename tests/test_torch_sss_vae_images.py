"""The vaescatter sphere's images under a box, a tent and a gaussian
filter (split from tests/test_torch_sss_slice.py, whose seeded model,
scene helpers, tolerances and check it shares): rendered from the JAX build
carried over by the bridge and from the port's own build, against the
JAX package's."""
import pytest

from test_torch_sss_slice import check_sphere_images, model  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("rfilter", ["box", "tent", "gaussian"])
@pytest.mark.parametrize("kind", ["vaescatter"])
def test_sss_sphere_images_match_jax(model, kind, rfilter):  # noqa: F811
    check_sphere_images(model, kind, rfilter)
