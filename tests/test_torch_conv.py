"""The port's conv ops (ops/conv7.py, ops/conv3.py) against the JAX
package's Pallas kernels, on CPU.

The Pallas kernels run in interpret mode, at the block sizes the JAX
package's own tests give them (test_ops.py, test_conv3_pallas.py); the
gradients go against jax.grad of the JAX entry points (the XLA conv's VJP).
Same numpy inputs, NHWC/HWIO there and NCHW/OIHW here. f32; tolerances
atol 2e-5 on conv7 (as test_ops.py holds the kernel to the XLA conv) and
2e-4 + 1e-4 rel on the 128-channel 3x3 convs and on every gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc
from vid2vid_tpu.ops import conv3_pallas as jc3
from vid2vid_tpu.ops import conv7_pallas as jc7
from vid2vid_tpu_torch.ops.conv3 import conv3_fused_padded, conv3_fused_plain, conv3_padded
from vid2vid_tpu_torch.ops.conv7 import conv7_padded, conv7_reflect, conv7_reflect_plain


def oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def hwio(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (2, 3, 1, 0))


def _kernel(rng, k, ci, co, scale):
    return (rng.standard_normal((k, k, ci, co)) * scale).astype(np.float32)


@pytest.mark.parametrize("b,h,w,ci,co", [(1, 16, 128, 20, 12), (2, 8, 64, 3, 3)])
def test_conv7_padded_matches_pallas_interpret(rng, b, h, w, ci, co):
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = _kernel(rng, 7, ci, co, 0.05)
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    want = jc7.conv7_pallas_padded(jnp.asarray(xp), jnp.asarray(k), block_rows=8,
                                   block_cols=64, interpret=True)
    before = conv7_padded.launches
    got = conv7_padded(nchw(xp), oihw(k))
    assert conv7_padded.launches == before  # a CPU tensor: the plain version
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(nhwc(conv7_reflect(nchw(x), oihw(k))), np.asarray(want),
                               atol=2e-5)


def test_conv7_reflect_grads_match_jax(rng):
    """Forward and jax.grad of sum(conv7_reflect(x, k)**2), both arguments;
    the port's bias adds per channel and takes its gradient too."""
    x = rng.standard_normal((1, 12, 16, 5)).astype(np.float32)
    k = _kernel(rng, 7, 5, 4, 0.05)
    bias = rng.standard_normal(4).astype(np.float32)

    def loss(x, k):
        return jnp.sum((jc7.conv7_reflect(x, k) + bias) ** 2)

    want_y = jc7.conv7_reflect(jnp.asarray(x), jnp.asarray(k)) + bias
    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt, bt = (t.requires_grad_() for t in (nchw(x), oihw(k), torch.from_numpy(bias)))
    y = conv7_reflect(xt, kt, bt)
    (y**2).sum().backward()
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), atol=2e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(hwio(kt.grad), np.asarray(gk), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), 2 * np.asarray(want_y).sum((0, 1, 2)),
                               atol=2e-4, rtol=1e-4)


def test_conv3_padded_matches_pallas_interpret_with_grads(rng):
    xp = rng.standard_normal((2, 10, 34, 128)).astype(np.float32)
    k = _kernel(rng, 3, 128, 16, 0.1)
    want = jc3.conv3_pallas_padded(jnp.asarray(xp), jnp.asarray(k), 8, 32, interpret=True)
    gx, gk = jax.grad(lambda a, b: jnp.sum(jc3.conv3_padded(a, b) ** 2), (0, 1))(
        jnp.asarray(xp), jnp.asarray(k))
    xt, kt = nchw(xp).requires_grad_(), oihw(k).requires_grad_()
    before = conv3_padded.launches
    y = conv3_padded(xt, kt)
    (y**2).sum().backward()
    assert conv3_padded.launches == before
    np.testing.assert_allclose(nhwc(y), np.asarray(want), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(hwio(kt.grad), np.asarray(gk), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("residual", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
def test_conv3_fused_matches_pallas_interpret(rng, relu, residual):
    h, w, c = 8, 32, 128
    xp = rng.standard_normal((2, h + 2, w + 2, c)).astype(np.float32)
    k = _kernel(rng, 3, c, c, 0.1)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    offset = (0.1 * rng.standard_normal(c)).astype(np.float32)
    res = rng.standard_normal((2, h, w, c)).astype(np.float32) if residual else None
    want = jc3.conv3_fused_padded(
        jnp.asarray(xp), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(offset),
        residual=None if res is None else jnp.asarray(res), relu=relu,
        block_rows=8, block_cols=32, interpret=True)
    args = (nchw(xp), oihw(k), torch.from_numpy(scale), torch.from_numpy(offset),
            None if res is None else nchw(res), relu)
    before = conv3_fused_padded.launches
    got = conv3_fused_padded(*args)
    assert conv3_fused_padded.launches == before
    torch.testing.assert_close(got, conv3_fused_plain(*args), rtol=0, atol=0)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4, rtol=1e-4)


def test_conv_ops_reject_bad_shapes():
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        conv7_reflect(x, torch.zeros(2, 3, 7, 7))
    with pytest.raises(ValueError, match="bias"):
        conv7_reflect(x, torch.zeros(2, 4, 7, 7), torch.zeros(3))
    with pytest.raises(ValueError, match="H, W >= 4"):
        conv7_reflect(x[:, :, :3], torch.zeros(2, 4, 7, 7))
    with pytest.raises(ValueError, match="H, W >= 7"):
        conv7_padded(x[:, :, :6], torch.zeros(2, 4, 7, 7))
    with pytest.raises(ValueError, match="3, 3"):
        conv3_padded(x, torch.zeros(2, 4, 7, 7))
    ab = torch.ones(2)
    with pytest.raises(ValueError, match="scale"):
        conv3_fused_padded(x, torch.zeros(2, 4, 3, 3), torch.ones(3), ab)
    with pytest.raises(ValueError, match="residual"):
        conv3_fused_padded(x, torch.zeros(2, 4, 3, 3), ab, ab, torch.zeros(1, 2, 8, 8))


def test_reflect_conv7_layer_folds_the_pad_in_eval_only(rng):
    """The single-image nets' 7x7 pair keeps nn.Conv2d's state-dict names;
    train mode pads then convolves, eval mode runs conv7_reflect with the
    pad folded in, and both give the reflect-padded conv."""
    from torch import nn

    from vid2vid_tpu_torch.nn.layers import reflect_conv7

    seq = nn.Sequential(*reflect_conv7(3, 5))
    ref = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 5, 7))
    ref.load_state_dict(seq.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 3, 9, 10)).astype(np.float32))
    with torch.no_grad():
        want = ref(x)
        torch.testing.assert_close(seq.train()(x), want, rtol=0, atol=0)
        torch.testing.assert_close(seq.eval()(x), want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            seq(x), conv7_reflect_plain(x, seq[1].weight, seq[1].bias), rtol=0, atol=0)
