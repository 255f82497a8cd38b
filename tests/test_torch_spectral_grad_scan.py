"""The spectral variant's gradients through the scan adjoint, in both
packages (split from tests/test_torch_spectral_slice.py, whose scenes,
tolerances and check it shares).  The proxy runs seed 1, as
tests/test_torch_bump_env_slice.py's gradients do (seed 0 bends a path
at a texel edge of the bump map)."""
import pytest

from test_torch_spectral_slice import check_render_grad
from torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("kind,key,replay,spp,seed", [
    ("fog", "media.params", False, 4, 0),
    ("bump_sky_proxy", "media.params", False, 4, 1),
    ("cornell_regen", "emitters.params", False, 8, 0)])
def test_spectral_render_grad_matches_jax(kind, key, replay, spp, seed):
    """render_grad of mean(image) in both packages."""
    check_render_grad(kind, key, replay, spp, seed)
