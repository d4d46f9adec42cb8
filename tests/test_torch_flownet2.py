"""The port's FlowNet2 stack (vid2vid_tpu_torch.models.flownet2) against the
JAX package's, on CPU, f32.

One set of JAX FlowNet2 variables (the tree of flax's init, drawn with
numpy: xavier-uniform kernels, the reference flow nets' own init, which
keeps the cascade's activations O(1), and random biases) is carried into
the port with from_jax and shared by every test of the module; each flow
net is held against its JAX counterpart at the sizes of
tests/test_flownet2_oracle.py, then FlowNet2 whole, its C / CS / CSS
variants and the FlowEstimator wrapper (the //64 resize round trip and the
confidence). Every output is asserted well above its bound, and a broken
copy of the cascade is asserted to leave it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vid2vid_tpu.models.flownet2.flownet2 as jax_flownet2
import vid2vid_tpu.models.flownet2.nets as jax_nets
import vid2vid_tpu_torch.models.flownet2.flownet2 as port_flownet2
from torch_parity import init_like, nchw, nhwc, randomize
from vid2vid_tpu.models.flownet2.flownet2 import FlowNet2 as JaxFlowNet2
from vid2vid_tpu.models.flownet2.wrapper import FlowEstimator as JaxFlowEstimator
from vid2vid_tpu.ops.correlation_pallas import correlation_pallas
from vid2vid_tpu_torch.models.flownet2.flownet2 import FlowNet2
from vid2vid_tpu_torch.models.flownet2.nets import FlowNetFusion
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator
from vid2vid_tpu_torch.ops.correlation import correlation
from vid2vid_tpu_torch.ops.warp import flow_warp
from vid2vid_tpu_torch.utils.from_jax import flownet2_state_dict

NET_ATOL = 2e-4   # each flow net (the oracle's bound)
FULL_ATOL = 5e-4  # FlowNet2 whole
FLOW_ATOL = 2e-3  # FlowEstimator flow after the resize round trip


@pytest.fixture(scope="module")
def weights():
    """(JAX FlowNet2 variables, the port's FlowNet2 on the same weights)."""
    z = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JaxFlowNet2().init, jax.random.key(0), z, z)
    rng = np.random.default_rng(0)
    variables = randomize(init_like(shapes, rng, xavier=True), rng)
    port = FlowNet2()
    result = port.load_state_dict(flownet2_state_dict(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return variables, port.eval()


def _pair(rng, h, w, t=None, noise=0.05):
    lead = (1,) if t is None else (1, t)
    im1 = rng.random(lead + (h, w, 3)).astype(np.float32)
    noise = noise * rng.standard_normal(im1.shape).astype(np.float32)
    return im1, np.clip(im1 + noise, 0.0, 1.0)


def _net_case(weights, rng, name, jax_cls, in_ch, h, w):
    variables, port = weights
    jvars = {"params": variables["params"][name]}
    x = (0.3 * rng.standard_normal((1, h, w, in_ch))).astype(np.float32)
    with torch.no_grad():
        got = getattr(port, name)(nchw(x))
    want = jax_cls().apply(jvars, jnp.asarray(x))
    return got, want


@pytest.mark.parametrize(
    "name,jax_cls,in_ch,h,w",
    [
        ("flownetc", jax_nets.FlowNetC, 6, 64, 128),
        ("flownets_1", jax_nets.FlowNetS, 12, 64, 64),
        ("flownets_d", jax_nets.FlowNetSD, 6, 64, 64),
    ],
    ids=["FlowNetC", "FlowNetS", "FlowNetSD"],
)
def test_flow_net_matches_jax(weights, rng, name, jax_cls, in_ch, h, w):
    (got,), (want,) = _net_case(weights, rng, name, jax_cls, in_ch, h, w)
    assert got.shape == (1, 2, h // 4, w // 4)
    assert float(got.abs().max()) > 10 * NET_ATOL  # not a trivially small flow
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=NET_ATOL)


def test_flownet_fusion_matches_jax(weights, rng):
    got, want = _net_case(weights, rng, "flownetfusion", jax_nets.FlowNetFusion,
                          11, 64, 64)
    assert got.shape == (1, 2, 64, 64)
    assert float(got.abs().max()) > 10 * NET_ATOL
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=NET_ATOL)


def test_flownetc_through_pallas_kernel(weights, rng, monkeypatch):
    """JAX's FlowNetC with its cost volume from the Pallas kernel (interpret
    mode) instead of correlation_ref: the port agrees within the same bound."""
    calls = []

    def pallas_corr(f1, f2, max_displacement=20, stride2=2):
        assert (max_displacement, stride2) == (20, 2)
        calls.append(f1.shape)
        return correlation_pallas(f1, f2, interpret=True)

    monkeypatch.setattr(jax_nets, "correlation", pallas_corr)
    (got,), (want,) = _net_case(weights, rng, "flownetc", jax_nets.FlowNetC, 6, 64, 128)
    assert calls == [(1, 8, 16, 256)]
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=NET_ATOL)


@pytest.fixture(scope="module")
def pair_case(weights):
    """A 64x64 frame pair and JAX FlowNet2's flow for it."""
    variables, _ = weights
    im1, im2 = _pair(np.random.default_rng(1), 64, 64)
    want = JaxFlowNet2().apply(variables, jnp.asarray(im1), jnp.asarray(im2))
    return im1, im2, np.asarray(want)


def _port_flow(port, im1, im2):
    with torch.no_grad():
        return nhwc(port(nchw(im1), nchw(im2)))


def test_flownet2_matches_jax(weights, pair_case):
    im1, im2, want = pair_case
    got = _port_flow(weights[1], im1, im2)
    assert got.shape == (1, 64, 64, 2)
    assert np.abs(got).max() > 10 * FULL_ATOL
    np.testing.assert_allclose(got, want, atol=FULL_ATOL)


@pytest.mark.parametrize(
    "name,subnets",
    [
        ("FlowNet2C", ("flownetc",)),
        ("FlowNet2CS", ("flownetc", "flownets_1")),
        ("FlowNet2CSS", ("flownetc", "flownets_1", "flownets_2")),
    ],
)
def test_flownet2_variant_matches_jax(weights, pair_case, name, subnets):
    """The C / CS / CSS cascades on FlowNet2's weights for their subnets."""
    variables, full = weights
    im1, im2, _ = pair_case
    port = getattr(port_flownet2, name)()
    port.load_state_dict(
        {k: v for k, v in full.state_dict().items() if k.split(".")[0] in subnets},
        strict=True,
    )
    jvars = {"params": {n: variables["params"][n] for n in subnets}}
    want = getattr(jax_flownet2, name)().apply(jvars, jnp.asarray(im1), jnp.asarray(im2))
    got = _port_flow(port.eval(), im1, im2)
    assert got.shape == (1, 64, 64, 2)
    assert np.abs(got).max() > 10 * FULL_ATOL
    np.testing.assert_allclose(got, np.asarray(want), atol=FULL_ATOL)


def _drop_warp(k):
    """The k-th of FlowNet2's four warps returns its image unwarped."""

    def mutate(monkeypatch):
        calls = []

        def warp(image, flow):
            calls.append(None)
            return image if len(calls) == k + 1 else flow_warp(image, flow)

        monkeypatch.setattr(port_flownet2, "flow_warp", warp)

    return mutate


def _swap_fusion_branches(monkeypatch):
    # the fusion input with the S2 and SD channels (flow, its norm, the
    # warp error) in each other's places
    perm = [0, 1, 2, 5, 6, 3, 4, 8, 7, 10, 9]
    forward = FlowNetFusion.forward
    monkeypatch.setattr(FlowNetFusion, "forward", lambda self, x: forward(self, x[:, perm]))


MUTATIONS = {
    "warp_after_c": _drop_warp(0),
    "warp_after_s1": _drop_warp(1),
    "warp_s2": _drop_warp(2),
    "warp_sd": _drop_warp(3),
    "bilinear_for_nearest": lambda mp: mp.setattr(
        port_flownet2, "_up4_nearest", port_flownet2._up4_bilinear),
    "fusion_order": _swap_fusion_branches,
    "channel_norm_squared": lambda mp: mp.setattr(
        port_flownet2, "channel_norm", lambda x: (x * x).sum(1, keepdim=True)),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_flownet2_bound_catches_a_broken_cascade(weights, pair_case, monkeypatch, mutation):
    """A copy of the cascade with one warp, upsampling or fusion detail
    wrong leaves FULL_ATOL: the whole-net bound is sensitive to each."""
    im1, im2, want = pair_case
    MUTATIONS[mutation](monkeypatch)
    assert np.abs(_port_flow(weights[1], im1, im2) - want).max() > FULL_ATOL


@pytest.fixture(scope="module")
def estimator(weights):
    est = FlowEstimator()
    est.net.load_state_dict(weights[1].state_dict(), strict=True)
    return est.eval()


def test_flow_estimator_matches_jax(weights, estimator, rng):
    """(B=1, T=2) frames at 96x160: the 5-D path and the //64 resize round
    trip; the bounds of tests/test_flownet2_oracle.py."""
    variables, _ = weights
    # noise of 0.15 (smoothed by the //64 resize) puts the squared warp
    # error near the 0.02 threshold, so the confidence map is mixed
    im1, im2 = _pair(rng, 96, 160, t=2, noise=0.15)
    before = (correlation.launches, flow_warp.launches)
    flow, conf = estimator(nchw(im1), nchw(im2))
    assert (correlation.launches, flow_warp.launches) == before  # plain on CPU
    assert flow.shape == (1, 2, 2, 96, 160) and conf.shape == (1, 2, 1, 96, 160)
    assert float(flow.abs().max()) > 10 * FLOW_ATOL
    jflow, jconf = JaxFlowEstimator()(variables, jnp.asarray(im1), jnp.asarray(im2))
    np.testing.assert_allclose(nhwc(flow), np.asarray(jflow), atol=FLOW_ATOL)
    # conf is a thresholded map resized bilinearly: compare away from the
    # float-sensitive threshold boundary
    assert (np.abs(nhwc(conf) - np.asarray(jconf)) < 1e-3).mean() >= 0.99
    assert 0.0 <= float(conf.min()) and float(conf.max()) <= 1.0
    assert 0.1 < float(conf.mean()) < 0.9


def test_flow_estimator_5d_equals_per_pair(estimator, rng):
    im1, im2 = (nchw(a) for a in _pair(rng, 64, 128, t=2))
    flow, conf = estimator(im1, im2)
    for t in range(2):
        f, c = estimator(im1[:, t], im2[:, t])
        assert f.shape == (1, 2, 64, 128) and c.shape == (1, 1, 64, 128)
        torch.testing.assert_close(flow[:, t], f, atol=1e-5, rtol=0)
        torch.testing.assert_close(conf[:, t], c, atol=0, rtol=0)


def test_flow_estimator_runs_convs_in_f32(estimator):
    """cuDNN's TF32 is off inside the net whatever the caller set, and the
    caller's setting is back afterwards."""
    seen = []
    hook = estimator.net.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        estimator(torch.zeros(1, 3, 64, 64), torch.zeros(1, 3, 64, 64))
        assert seen == [False] and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        hook.remove()


def test_flow_estimator_rejects_mismatched_frames(estimator):
    with pytest.raises(ValueError, match="must be equal"):
        estimator(torch.zeros(1, 3, 64, 64), torch.zeros(1, 3, 64, 128))
