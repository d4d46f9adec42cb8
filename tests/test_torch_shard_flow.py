"""FlowNet2 on training's model axis (vid2vid_tpu_torch/models/flownet2 with a
parallel/halo.py::WidthShard) on the CPU, in one process: N shards of each
case on the threads of one parallel.collectives.LocalGroup (the
collectives answered in memory), against the whole tensor.

  - the halo kinds FlowNet2 adds: "transpose" (a 4x4 stride-2 transposed
    conv's input columns) through the exchange against fetch_plain, and
    the column resizes (ops/resize.py: bilinear at half-pixel centres and
    nearest, between two widths) against F.interpolate of the whole;
  - ShardConvTranspose2d against nn.ConvTranspose2d, forward and input
    gradient;
  - the correlation's shard path (ops.correlation(..., shard=): f2's halo
    fetched, then the column-halo mode correlation_halo) against
    correlation_plain of the whole tensor at the checks' tolerance (atol
    and rtol 1e-5) and against JAX's correlation_ref, with empty shards;
  - each flow net (FlowNetC, FlowNetS, FlowNetSD, FlowNetFusion) sharded
    against the unsharded port and the JAX net, and the FlowEstimator
    sharded against the unsharded port (flow within 1e-4 (1 + max|flow|);
    the confidence equal wherever the unsharded warp error lies more than
    1e-4 from the threshold, before the resize back) and against the JAX
    FlowEstimator (tests/test_torch_flownet2.py's bounds).

Shapes: 2, 3 and 8 shards at 64 x 192 (no resize; 3 columns at FlowNet2's
1/64: unequal shards on 2, 1-column shards on 3, empty ones on 8) and 2
and 8 shards at 96 x 200 (resized to 64 x 192 and back). The weights are
tests/test_torch_flownet2.py's: flax's init tree drawn with numpy
(torch_parity.init_like, xavier) and carried into the port by from_jax.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
import vid2vid_tpu.models.flownet2.nets as jax_nets
from vid2vid_tpu.models.flownet2.flownet2 import FlowNet2 as JaxFlowNet2
from vid2vid_tpu.models.flownet2.wrapper import FlowEstimator as JaxFlowEstimator
from vid2vid_tpu.ops.correlation import correlation_ref
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator
from vid2vid_tpu_torch.nn.layers import ShardConvTranspose2d
from vid2vid_tpu_torch.ops.correlation import (
    correlation,
    correlation_halo,
    correlation_plain,
)
from vid2vid_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.collectives import LocalGroup
from vid2vid_tpu_torch.utils.from_jax import flownet2_state_dict

NET_ATOL = 2e-4   # a flow net against JAX (tests/test_torch_flownet2.py)
FLOW_ATOL = 2e-3  # the FlowEstimator's flow against JAX, after the resize round trip
CORR_TOL = dict(atol=1e-5, rtol=1e-5)  # chip_smoke.py's TOL["correlation"]
CONF_MARGIN = 1e-4  # conf compared where the warp error is this far from the threshold
# (H, W, shards) of the FlowEstimator cases
CASES = [(64, 192, 2), (64, 192, 3), (64, 192, 8), (96, 200, 2), (96, 200, 8)]


@pytest.fixture(autouse=True)
def one_thread():
    with tp.torch_threads(1):
        yield


def on_shards(n: int, width: int, fn, height: int = 1) -> list:
    """fn(shard) on each of n shards of a width, each on a thread of one
    LocalGroup; their results in shard order."""
    group = LocalGroup(n)

    def member(i):
        with group.member(i):
            return fn(halo.make_shard(i, n, width, group, height))

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        return [f.result() for f in [pool.submit(member, i) for i in range(n)]]


def _seeded(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _flow_close(got, want):
    """The flow criterion: atol 1e-4 (1 + max|want|)."""
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * (1 + float(want.abs().max())))


# ------------------------------------------------ halo kinds and resizes


@pytest.mark.parametrize("n,width", [(2, 12), (3, 12), (8, 12), (8, 3)],
                         ids=["12_on_2", "12_on_3", "12_on_8", "3_on_8"])
def test_transpose_columns_on_shards_equal_their_plain_version(n, width):
    """halo.fetch of kind ("transpose", 4, 2, 1) on each shard (the input
    columns whose taps reach its output columns of the 2x wider output;
    halos from several ranks at narrow shards, none on an empty one) is
    fetch_plain of the whole tensor, bit for bit; its backward sends the
    halos' gradients home."""
    spec = ("transpose", 4, 2, 1)
    x = _seeded(1, 2, 3, width)
    xw = x.clone().requires_grad_(True)
    cols = [halo.fetch_plain(xw, halo.make_shard(i, n, width), spec) for i in range(n)]
    cots = [_seeded(*c.shape, seed=10 + i) for i, c in enumerate(cols)]
    (want,) = torch.autograd.grad(sum((c * g).sum() for c, g in zip(cols, cots)), [xw])

    def run(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        got = halo.fetch(xl, sh, spec)
        assert torch.equal(got, cols[sh.index].detach())
        return torch.autograd.grad((got * cots[sh.index]).sum(), [xl], allow_unused=True)[0]

    grads = [torch.zeros(1, 2, 3, 0) if g is None else g for g in on_shards(n, width, run)]
    torch.testing.assert_close(torch.cat(grads, -1), want, rtol=0, atol=1e-6)


# (in (H, W), out (H, W), shards, mode): x4 up at FlowNet2's 1/4 level, the
# wrapper's resize back (192 -> 200) and a downscale, nearest x4
RESIZES = [((16, 48), (64, 192), 3, "linear"), ((16, 48), (64, 192), 8, "linear"),
           ((64, 192), (96, 200), 2, "linear"), ((64, 192), (96, 200), 8, "linear"),
           ((24, 50), (16, 36), 4, "linear"), ((16, 48), (64, 192), 8, "nearest"),
           ((16, 50), (64, 200), 8, "nearest")]


@pytest.mark.parametrize("src,dst,n,mode", RESIZES,
                         ids=[f"{s[1]}to{d[1]}_on_{n}_{m}" for s, d, n, m in RESIZES])
def test_a_resize_on_shards_equals_the_whole(src, dst, n, mode):
    """ops/resize.py on each shard (the source columns fetched, sampled at
    their global coordinates) gives its columns of F.interpolate of the
    whole tensor, split by the same rule, within 1e-6 (the same float32
    taps; only a fused multiply-add may round otherwise)."""
    x = _seeded(2, 3, *src)
    fn = resize_bilinear if mode == "linear" else resize_nearest
    want = fn(x, *dst)
    got = on_shards(n, src[1], lambda sh: fn(sh.local(x), *dst, sh))
    for i, g in enumerate(got):
        cols = slice(*halo.split(dst[1], n, i))
        torch.testing.assert_close(g, want[..., cols], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,width", [(2, 8), (3, 12), (8, 6)], ids=["8_on_2", "12_on_3",
                                                                   "6_on_8"])
def test_shard_conv_transpose_equals_conv_transpose(n, width):
    """ShardConvTranspose2d(4, 2, 1) on each shard: its columns of the 2x
    wider output (empty on some shards of 8), the input gradient of the
    shards side by side the whole one's, and the weight gradients summed
    the whole layer's."""
    layer = ShardConvTranspose2d(3, 4, 4, 2, 1)
    torch.nn.init.uniform_(layer.bias, generator=torch.Generator().manual_seed(1))
    x = _seeded(2, 3, 5, width)
    xw = x.clone().requires_grad_(True)
    y = torch.nn.ConvTranspose2d.forward(layer, xw)
    assert y.shape[-1] == 2 * width
    cot = _seeded(*y.shape, seed=2)
    want = torch.autograd.grad((y * cot).sum(), [xw, layer.weight, layer.bias])

    def run(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        yl = layer(xl, sh)
        out = layer.output_shard(sh)
        torch.testing.assert_close(yl, y.detach()[..., out.x0 : out.x1], rtol=1e-5, atol=1e-6)
        g = torch.autograd.grad((yl * cot[..., out.x0 : out.x1]).sum(),
                                [xl, layer.weight, layer.bias], allow_unused=True)
        return [torch.zeros_like(w) if a is None else a for a, w in zip(g, [xl, *want[1:]])]

    got = on_shards(n, width, run)
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), want[0], rtol=1e-5,
                               atol=1e-5)
    for k in (1, 2):
        torch.testing.assert_close(sum(g[k] for g in got), want[k], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the correlation


@pytest.mark.parametrize("n,shape", [(2, (2, 9, 8, 24)), (3, (1, 20, 9, 24)),
                                     (8, (1, 5, 6, 24)), (8, (1, 4, 5, 3))],
                         ids=["24_on_2", "24_on_3", "24_on_8", "3_on_8"])
def test_the_correlation_on_shards_equals_the_whole(n, shape):
    """correlation(f1, f2, shard=) on each shard (f2's 20-column halo from
    up to all the other ranks, zeros past the image's edges) is its columns
    of correlation_plain of the whole tensor (atol and rtol 1e-5) and of
    JAX's correlation_ref; the column-halo mode runs its plain version on
    the CPU (no launch)."""
    f1, f2 = _seeded(*shape), _seeded(*shape, seed=1)
    want = correlation_plain(f1, f2)
    ref = tp.nchw(correlation_ref(jnp.asarray(tp.nhwc(f1)), jnp.asarray(tp.nhwc(f2)), 20, 2))
    before = correlation_halo.launches
    got = on_shards(n, shape[-1], lambda sh: correlation(sh.local(f1), sh.local(f2), shard=sh))
    assert correlation_halo.launches == before
    for i, g in enumerate(got):
        cols = slice(*halo.split(shape[-1], n, i))
        assert g.shape == want[..., cols].shape
        torch.testing.assert_close(g, want[..., cols], **CORR_TOL)
        torch.testing.assert_close(g, ref[..., cols], **CORR_TOL)


# ------------------------------------------------------ the flow nets, FlowNet2


@pytest.fixture(scope="module")
def weights():
    """(JAX FlowNet2 variables, the port's FlowEstimator on the same
    weights): tests/test_torch_flownet2.py's draw."""
    z = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JaxFlowNet2().init, jax.random.key(0), z, z)
    rng = np.random.default_rng(0)
    variables = tp.randomize(tp.init_like(shapes, rng, xavier=True), rng)
    est = FlowEstimator()
    est.net.load_state_dict(flownet2_state_dict(variables), strict=True)
    return variables, est.eval()


# (port name, JAX class, input channels, input whole on every rank)
NETS = {"FlowNetC": ("flownetc", jax_nets.FlowNetC, 6, True),
        "FlowNetS": ("flownets_1", jax_nets.FlowNetS, 12, False),
        "FlowNetSD": ("flownets_d", jax_nets.FlowNetSD, 6, True),
        "FlowNetFusion": ("flownetfusion", jax_nets.FlowNetFusion, 11, False)}


@pytest.fixture(scope="module")
def net_cases(weights):
    """Each net's input at 64 x 192, its unsharded port output and the JAX
    net's on the same weights."""
    variables, est = weights
    out = {}
    for name, (attr, jax_cls, cin, _) in NETS.items():
        x = (0.3 * np.random.default_rng(3).standard_normal((1, 64, 192, cin))).astype(np.float32)
        with torch.no_grad():
            whole = getattr(est.net, attr)(tp.nchw(x))
        jvars = {"params": variables["params"][attr]}
        ref = jax_cls().apply(jvars, jnp.asarray(x))
        out[name] = (tp.nchw(x), whole if torch.is_tensor(whole) else whole[0],
                     tp.nchw(np.asarray(ref if name == "FlowNetFusion" else ref[0])))
    return out


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("name", list(NETS))
def test_a_flow_net_on_shards_equals_the_whole(weights, net_cases, name, n):
    """Each flow net on n shards of a 64 x 192 input (whole on every rank
    for FlowNetC and FlowNetSD, the rank's columns for FlowNetS and the
    fusion net): the shards' flows side by side against the unsharded
    port's (atol 1e-4 (1 + max|flow|)) and the JAX net's (NET_ATOL)."""
    attr, _, _, whole_input = NETS[name]
    net = getattr(weights[1].net, attr)
    x, want, ref = net_cases[name]

    def run(sh):
        with torch.no_grad():
            out = net(x if whole_input else sh.local(x), sh)
        return out if torch.is_tensor(out) else out[0]

    got = torch.cat(on_shards(n, x.shape[-1], run), -1)
    _flow_close(got, want)
    np.testing.assert_allclose(tp.nhwc(got), tp.nhwc(ref), atol=NET_ATOL)


def _frames(h, w, seed=1):
    """(1, 2, H, W, 3) frame pairs in [0, 1] whose noise puts part of the
    squared warp error under the threshold (a mixed confidence map): 0.08
    at FlowNet2's size, 0.15 where the //64 resize smooths it."""
    rng = np.random.default_rng(seed)
    noise = 0.08 if h % 64 == w % 64 == 0 else 0.15
    im1 = rng.random((1, 2, h, w, 3)).astype(np.float32)
    im2 = np.clip(im1 + noise * rng.standard_normal(im1.shape).astype(np.float32), 0.0, 1.0)
    return im1, im2


@pytest.fixture(scope="module")
def estimates(weights):
    """At 64 x 192 and 96 x 200: the frames, the unsharded port's
    (flow, conf) and (flow, warp error) at FlowNet2's size, and the JAX
    FlowEstimator's (flow, conf)."""
    variables, est = weights
    out = {}
    for h, w in {(h, w) for h, w, _ in CASES}:
        im1, im2 = _frames(h, w)
        t1, t2 = tp.nchw(im1), tp.nchw(im2)
        with torch.no_grad():
            flat = [t.reshape((-1,) + t.shape[2:]) for t in (t1, t2)]
            net_flow, err, _ = est.flow_and_error(*flat)
        flow, conf = est(t1, t2)
        jflow, jconf = JaxFlowEstimator()(variables, jnp.asarray(im1), jnp.asarray(im2))
        out[h, w] = (t1, t2, flow, conf, net_flow, err, np.asarray(jflow), np.asarray(jconf))
    return out


@pytest.mark.parametrize("h,w,n", CASES, ids=[f"{h}x{w}_on_{n}" for h, w, n in CASES])
def test_the_flow_estimator_on_shards_equals_the_whole(weights, estimates, h, w, n):
    """FlowEstimator(im1, im2, shard) on n shards of whole (1, 2, 3, H, W)
    frames: each shard's flow and confidence are its columns (the frames'
    split); gathered, the flow is the unsharded port's within 1e-4 (1 +
    max|flow|), at FlowNet2's size and after the resize back, and the JAX
    FlowEstimator's within FLOW_ATOL; the confidence at FlowNet2's size
    equals the unsharded one wherever the unsharded warp error lies more
    than CONF_MARGIN from the threshold (and, unresized, the returned
    confidence too), and stays within tests/test_torch_flownet2.py's
    share of the JAX one; the map holds both values."""
    est = weights[1]
    t1, t2, flow, conf, net_flow, err, jflow, jconf = estimates[h, w]
    thr = est.conf_threshold

    def run(sh):
        with torch.no_grad():
            flat = [t.reshape((-1,) + t.shape[2:]) for t in (t1, t2)]
            nf, ne, ns = est.flow_and_error(*flat, sh)
            f, c = est(t1, t2, shard=sh)
        assert f.shape[-1] == c.shape[-1] == sh.width and ne.shape[-1] == ns.width
        return f, c, nf, ne

    got = on_shards(n, w, run, h)
    f, c, nf, ne = (torch.cat([g[k] for g in got], -1) for k in range(4))
    _flow_close(nf, net_flow)
    _flow_close(f, flow)
    away = (err - thr).abs() > CONF_MARGIN
    assert away.float().mean() > 0.9
    assert torch.equal((ne < thr)[away], (err < thr)[away])
    if (h, w) == net_flow.shape[-2:]:
        assert torch.equal(c[away.reshape(c.shape)], conf[away.reshape(c.shape)])
    np.testing.assert_allclose(tp.nhwc(f), jflow, atol=FLOW_ATOL)
    assert (np.abs(tp.nhwc(c) - jconf) < 1e-3).mean() >= 0.99
    assert 0.02 < float(c.mean()) < 0.98  # both values, hundreds of pixels each


def test_the_estimator_refuses_a_shard_of_another_width(weights):
    """The frames' width is the shard's whole width, or the call raises."""
    sh = halo.make_shard(0, 2, 128, LocalGroup(2), 64)
    with pytest.raises(ValueError, match="a shard of width 128 for frames 192 wide"):
        weights[1](torch.zeros(1, 3, 64, 192), torch.zeros(1, 3, 64, 192), shard=sh)
