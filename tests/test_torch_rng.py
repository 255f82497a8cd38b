"""The port's counter RNG against liverrenderer_tpu.core.rng: bit-exact.

Every per-pixel comparison between the two packages rests on identical
random streams, so the tolerance here is zero: the uint32 words and the
floats derived from them must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liverrenderer_tpu.core import rng as jrng
from liverrenderer_tpu_torch.core import rng as trng
from torch_threads import torch_threads_per_worker  # noqa: F401

# (pixel, sample, seed) grid, including ids and seeds near 2^32 where the
# uint32 products wrap
PIX = np.concatenate([np.arange(64), [102719, 2**31 - 1, 2**32 - 1]])
SAMP = np.array([0, 1, 7, 63, 255, 65535])
SEEDS = [0, 1, 12345, 2**32 - 1]


def _grid():
    p, s = np.meshgrid(PIX, SAMP, indexing="ij")
    return p.reshape(-1).astype(np.uint32), s.reshape(-1).astype(np.uint32)


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", SEEDS)
def test_make_sampler_streams_bit_exact(seed):
    pix, samp = _grid()
    js = jrng.make_sampler(jnp.asarray(pix), jnp.asarray(samp),
                           np.uint32(seed))
    ts = trng.make_sampler(torch.from_numpy(pix.astype(np.int64)),
                           torch.from_numpy(samp.astype(np.int64)), seed)
    np.testing.assert_array_equal(ts.seed.numpy(), _u32(js.seed))
    # a draw sequence like the bounce's: 1d, 2d, nd(6), 1d, 2d
    for step in range(5):
        if step in (0, 3):
            ju, js = js.next_1d()
            tu, ts = ts.next_1d()
        elif step == 2:
            ju, js = js.next_nd(6)
            tu, ts = ts.next_nd(6)
        else:
            ju, js = js.next_2d()
            tu, ts = ts.next_2d()
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ts.dim.numpy(), _u32(js.dim))


def test_pcg4d_and_hash_bit_exact(np_rng):
    v = np_rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint64)
    out_j = np.asarray(jrng._pcg4d(jnp.asarray(v.astype(np.uint32))))
    out_t = trng._pcg4d(torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(out_t.numpy(), _u32(out_j))
    a, b = v[:, 0].astype(np.uint32), v[:, 1].astype(np.uint32)
    np.testing.assert_array_equal(
        trng.hash_u32(torch.from_numpy(a.astype(np.int64)),
                      torch.from_numpy(b.astype(np.int64))).numpy(),
        _u32(jrng.hash_u32(jnp.asarray(a), jnp.asarray(b))))
    bits = torch.from_numpy(out_t.numpy()[:, 0])
    np.testing.assert_array_equal(
        trng._to_unit_float(bits).numpy(),
        np.asarray(jrng._to_unit_float(jnp.asarray(out_j[:, 0]))))


def test_other_sampler_kinds_raise():
    """The five sampler plugins of the JAX package are ported; a name it
    does not know raises instead of drawing one stream for every sample
    of a pixel."""
    for kind in trng.KINDS:
        trng.make_sampler(torch.arange(4), 0, 0, kind=kind, spp=4)
    with pytest.raises(ValueError, match="unknown sampler"):
        trng.make_sampler(torch.arange(4), 0, 0, kind="halton")
