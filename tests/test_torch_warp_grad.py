"""The warp's gradients in the port against the JAX package's, on the CPU.

The JAX package's flow_warp has a hand-written VJP (vid2vid_tpu/ops/warp.py::
_flow_warp_bwd): the bilinear splat for the image and the patch
formulation's derivative for the flow, where jnp.clip passes half the
gradient when a fractional weight sits exactly on 0 or 1 (every integer
sample point, so every zero flow). The port's flow_warp_backward_plain, and
torch.autograd through the port's flow_warp and warp_blend, are held to
jax.vjp of flow_warp and of nn/composite.py::_blend at 1e-5 in f32, on
flows that include zero flow, integer flows and samples far outside the
image. gradcheck holds the plain backward to finite differences in f64,
away from the ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc
from vid2vid_tpu.nn.composite import _blend
from vid2vid_tpu.ops.warp import flow_warp as jax_flow_warp
from vid2vid_tpu.ops.warp import flow_warp_ref
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_backward_plain,
    flow_warp_bwd,
    warp_blend,
    warp_blend_backward_plain,
    warp_blend_bwd,
)

ATOL = 1e-5
SHAPES = [(2, 3, 9, 13), (1, 4, 16, 24), (2, 3, 2, 2)]


def _case(rng, b, c, h, w):
    """NHWC (image, flow, cotangent): image 0 has zero flow, image 1 integer
    flows on its top third; the rest are flows of ~3 px with some ~20 px,
    far outside the image."""
    image = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    flow[:, -1:] *= 7.0
    flow[0] = 0.0
    if b > 1:
        flow[1, : max(1, h // 3)] = np.round(flow[1, : max(1, h // 3)])
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return image, flow, g


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_jax_vjp(rng, shape):
    image, flow, g = _case(rng, *shape)
    _, vjp = jax.vjp(jax_flow_warp, jnp.asarray(image), jnp.asarray(flow))
    want_di, want_df = vjp(jnp.asarray(g))
    for fn in (flow_warp_backward_plain, flow_warp_bwd):  # CPU: the same path
        di, df = fn(nchw(image), nchw(flow), nchw(g))
        np.testing.assert_allclose(nhwc(di), np.asarray(want_di), atol=ATOL, rtol=0)
        np.testing.assert_allclose(nhwc(df), np.asarray(want_df), atol=ATOL, rtol=0)
    # the cases reach every branch of the clip's gradient
    assert np.abs(np.asarray(want_df)).max() > 0.1


def test_zero_flow_tie_is_half_of_flow_warp_ref():
    """At zero flow JAX's flow_warp passes half of flow_warp_ref's
    d/dflow_x inside the image and 0.5 * (v[w-1] - v[w-2]) at the last
    column, where flow_warp_ref's autodiff gives 0; the port follows
    flow_warp."""
    image = (np.arange(20, dtype=np.float32) ** 1.5).reshape(1, 4, 5, 1)
    flow = np.zeros((1, 4, 5, 2), np.float32)
    g = np.ones_like(image)
    _, df = flow_warp_backward_plain(nchw(image), nchw(flow), nchw(g))
    _, vjp_ref = jax.vjp(flow_warp_ref, jnp.asarray(image), jnp.asarray(flow))
    ref_dfx = np.asarray(vjp_ref(jnp.asarray(g))[1])[0, 0, 1, 0]
    dfx = nhwc(df)[0, :, :, 0]
    np.testing.assert_allclose(dfx[0, 1], 0.5 * ref_dfx, rtol=1e-6)
    v = image[0, 0, :, 0]
    np.testing.assert_allclose(dfx[0, 4], 0.5 * (v[4] - v[3]), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_autograd_through_flow_warp_matches_jax(rng, shape):
    image, flow, g = _case(rng, *shape)
    out, vjp = jax.vjp(jax_flow_warp, jnp.asarray(image), jnp.asarray(flow))
    want = vjp(jnp.asarray(g))
    leaves = [nchw(a).requires_grad_() for a in (image, flow)]
    got = flow_warp(*leaves)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=ATOL, rtol=0)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(nhwc(leaf.grad), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_autograd_through_warp_blend_matches_jax_blend(rng, shape):
    prev, flow, g = _case(rng, *shape)
    raw = rng.standard_normal(prev.shape).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, prev.shape[:3] + (1,)).astype(np.float32)
    args = (raw, prev, flow, weight)
    out, vjp = jax.vjp(_blend, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    leaves = [nchw(a).requires_grad_() for a in args]
    got = warp_blend(*leaves)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=ATOL, rtol=0)
    plain = warp_blend_backward_plain(*(nchw(a) for a in args), nchw(g))
    on_cpu = warp_blend_bwd(*(nchw(a) for a in args), nchw(g))
    for leaf, p, c, w in zip(leaves, plain, on_cpu, want):
        np.testing.assert_allclose(nhwc(leaf.grad), np.asarray(w), atol=ATOL, rtol=0)
        torch.testing.assert_close(p, leaf.grad, atol=0, rtol=0)
        torch.testing.assert_close(c, leaf.grad, atol=0, rtol=0)


def _off_ties(rng, b, c, h, w):
    """f64 (image, flow) whose sample points keep 1e-2 from every integer,
    so the finite differences never cross a tie."""
    image = torch.from_numpy(rng.standard_normal((b, c, h, w)))
    base = rng.integers(-3, 4, (b, 2, h, w)).astype(np.float64)
    frac = rng.uniform(0.05, 0.95, (b, 2, h, w))
    return image, torch.from_numpy(base + frac)


@pytest.mark.parametrize("fn", ["flow_warp", "warp_blend"])
def test_gradcheck_f64_away_from_ties(rng, fn):
    image, flow = _off_ties(rng, 2, 2, 5, 6)
    if fn == "flow_warp":
        args = (image, flow)
        op = flow_warp
    else:
        raw = torch.from_numpy(rng.standard_normal(image.shape))
        weight = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 1, 5, 6)))
        args = (raw, image, flow, weight)
        op = warp_blend
    args = tuple(a.requires_grad_() for a in args)
    assert torch.autograd.gradcheck(op, args, eps=1e-6, atol=1e-7, rtol=1e-6)


def test_backward_rejects_images_under_2x2():
    image, flow = torch.zeros(1, 3, 1, 5), torch.zeros(1, 2, 1, 5)
    with pytest.raises(ValueError, match="at least 2"):
        flow_warp_backward_plain(image, flow, image)
    leaf = image.clone().requires_grad_()
    with pytest.raises(ValueError, match="at least 2"):
        flow_warp(leaf, flow).sum().backward()
