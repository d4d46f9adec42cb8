"""The port's correlation (vid2vid_tpu_torch.ops.correlation) against the JAX
package's correlation_ref and its Pallas kernel (interpret mode), on CPU.

Same numpy inputs through both; the port is NCHW in and out, JAX NHWC.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc
from vid2vid_tpu.ops.correlation import correlation_ref
from vid2vid_tpu.ops.correlation_pallas import correlation_pallas
from vid2vid_tpu_torch.ops.correlation import correlation, correlation_plain

ATOL = 1e-5


@pytest.mark.parametrize(
    "shape,md,s2",
    [
        ((1, 24, 32, 8), 20, 2),
        ((2, 9, 13, 5), 20, 2),   # ragged: H, W, C fill no tile
        ((1, 24, 32, 8), 4, 1),
        ((2, 9, 13, 5), 4, 1),
    ],
    ids=["24x32-md20", "ragged-md20", "24x32-md4s1", "ragged-md4s1"],
)
def test_plain_matches_correlation_ref(rng, shape, md, s2):
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = correlation_plain(nchw(f1), nchw(f2), md, s2)
    want = correlation_ref(jnp.asarray(f1), jnp.asarray(f2), md, s2)
    d = 2 * (md // s2) + 1
    assert got.shape == (shape[0], d * d, shape[1], shape[2])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_plain_matches_pallas_kernel_interpret(rng):
    f1, f2 = (rng.standard_normal((1, 24, 32, 8)).astype(np.float32) for _ in range(2))
    got = correlation_plain(nchw(f1), nchw(f2))
    want = correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), interpret=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_zero_padding_all_ones():
    """All-ones inputs: each output counts the in-image taps of its
    displacement (the case of tests/test_pallas.py)."""
    ones = torch.ones(1, 4, 8, 32)
    got = correlation_plain(ones, ones)
    want = correlation_pallas(jnp.ones((1, 8, 32, 4)), jnp.ones((1, 8, 32, 4)),
                              interpret=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)
    # zero displacement (channel 220 = 10 * 21 + 10) is 1 everywhere; the
    # largest displacement reaches outside an 8-row image from every row
    assert torch.all(got[0, 220] == 1.0)
    assert torch.all(got[0, 0] == 0.0)


def test_cpu_wrapper_takes_plain_path(rng):
    f1, f2 = (nchw(rng.standard_normal((2, 9, 13, 5)).astype(np.float32))
              for _ in range(2))
    before = correlation.launches
    torch.testing.assert_close(
        correlation(f1, f2), correlation_plain(f1, f2), rtol=0, atol=0
    )
    assert correlation.launches == before  # no kernel on a CPU tensor


def test_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="must be equal"):
        correlation(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 9))
    with pytest.raises(ValueError, match="must be equal"):
        correlation(torch.zeros(4, 8, 8), torch.zeros(4, 8, 8))
