"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Shapes the main path never gives them: channel counts that fill no tile,
images smaller than a tile and ragged at both edges, batch > 1, flows far
past the borders. Skips without a GPU. The file imports no JAX, so on a
machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from vid2vid_tpu_torch.ops.conv3 import (
    conv3_fused_padded,
    conv3_fused_plain,
    conv3_padded,
    conv3_plain,
)
from vid2vid_tpu_torch.ops.conv7 import (
    conv7_padded,
    conv7_plain,
    conv7_reflect,
    conv7_reflect_plain,
)
from vid2vid_tpu_torch.ops.correlation import correlation, correlation_plain
from vid2vid_tpu_torch.ops.respair import respair, respair_plain
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_backward_plain,
    flow_warp_bwd,
    flow_warp_plain,
    warp_blend,
    warp_blend_backward_plain,
    warp_blend_bwd,
    warp_blend_plain,
)

pytestmark = pytest.mark.cuda

# kernel vs plain-in-f32 on the same inputs (the bounds of chip_smoke.py)
TOL = {
    ("respair", torch.float32): dict(atol=1e-3, rtol=1e-4),
    ("respair", torch.bfloat16): dict(atol=5e-2, rtol=2e-2),
    ("warp", torch.float32): dict(atol=1e-5, rtol=0.0),
    ("warp", torch.bfloat16): dict(atol=1e-2, rtol=4e-3),
    ("correlation", torch.float32): dict(atol=1e-5, rtol=1e-5),
    # the splat sums with atomics in an order that changes from run to run:
    # f32 rounding of up to ~100 terms of O(1) where the border gathers
    # many samples, hence atol 1e-4 + rtol 1e-5 in f32
    ("warp_bwd", torch.float32): dict(atol=1e-4, rtol=1e-5),
    ("warp_bwd", torch.bfloat16): dict(atol=1e-2, rtol=8e-3),
    # f32: the sum order of up to 49*Ci products differs; bf16: the output's
    # rounding to bf16 (2**-8 of the value) on top
    ("conv", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("conv", torch.bfloat16): dict(atol=2e-2, rtol=1e-2),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA C++ for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(name, got, want, dtype):
    tol = TOL[(name, dtype)]
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    assert bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,c,h,w",
    # the last grid has 384 blocks, more than two per SM of an H100: it runs
    # the template's three-blocks-per-SM instantiation (csrc/conv_kxk.cuh)
    [(2, 3, 5, 7), (1, 17, 13, 37), (1, 40, 9, 33), (2, 96, 8, 32), (1, 33, 2, 2),
     (2, 70, 61, 250)],
)
def test_respair_kernel_any_shape(cuda, dtype, b, c, h, w):
    g = torch.Generator().manual_seed(c * 1000 + h)
    x = torch.randn((b, c, h, w), generator=g)
    k0, k1 = (torch.randn((c, c, 3, 3), generator=g) / math.sqrt(9 * c) for _ in range(2))
    ab = [tuple(torch.randn(c, generator=g).to(cuda) for _ in range(2)) for _ in range(2)]
    x, k0, k1 = (t.to(cuda, dtype) for t in (x, k0, k1))
    before = respair.launches
    got = respair(x, k0, ab[0], k1, ab[1])
    assert respair.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = respair_plain(x.float(), k0.float(), ab[0], k1.float(), ab[1])
    _close("respair", got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,scale", [(2, 3, 5, 7, 4.0), (1, 4, 17, 33, 30.0)])
def test_warp_blend_kernel_any_shape(cuda, dtype, b, c, h, w, scale):
    g = torch.Generator().manual_seed(h)
    raw, prev = (torch.randn((b, c, h, w), generator=g) for _ in range(2))
    flow = scale * torch.randn((b, 2, h, w), generator=g)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g))
    args = [t.to(cuda, dtype) for t in (raw, prev, flow, weight)]
    before = warp_blend.launches
    got = warp_blend(*args)
    assert warp_blend.launches == before + 1
    _close("warp", got, warp_blend_plain(*(a.float() for a in args)), dtype)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 6, 6, device=cuda)
    k = torch.zeros(8, 8, 3, 3, device=cuda)
    ab = (torch.ones(8, device=cuda), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        respair(x.transpose(2, 3), k, ab, k, ab)
    with pytest.raises(ValueError, match="not supported"):
        respair(x.half(), k.half(), ab, k.half(), ab)
    with pytest.raises(ValueError, match="dtype"):
        respair(x, k, (ab[0].double(), ab[1]), k, ab)
    img = torch.zeros(1, 3, 6, 6, device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        warp_blend(img.cpu(), img, torch.zeros(1, 2, 6, 6, device=cuda),
                   torch.zeros(1, 1, 6, 6, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,c,h,w,scale", [(2, 3, 5, 7, 4.0), (1, 17, 7, 9, 30.0), (2, 3, 1, 1, 2.0)]
)
def test_flow_warp_kernel_any_shape(cuda, dtype, b, c, h, w, scale):
    g = torch.Generator().manual_seed(c * 100 + h)
    image = torch.randn((b, c, h, w), generator=g)
    flow = scale * torch.randn((b, 2, h, w), generator=g)
    args = [t.to(cuda, dtype) for t in (image, flow)]
    before = flow_warp.launches
    got = flow_warp(*args)
    assert flow_warp.launches == before + 1
    assert got.dtype == dtype and got.shape == image.shape
    _close("warp", got, flow_warp_plain(*(a.float() for a in args)), dtype)


def _warp_bwd_case(b, c, h, w, scale, seed, device, dtype):
    """(image, flow, g): flows of `scale` px, with integer flows (the tie
    rule) on the first image and on a band of the others."""
    g = torch.Generator().manual_seed(seed)
    image = torch.randn((b, c, h, w), generator=g)
    flow = scale * torch.randn((b, 2, h, w), generator=g)
    flow[0] = torch.round(flow[0])
    flow[:, :, : h // 3] = 0.0
    cot = torch.randn((b, c, h, w), generator=g)
    return [t.to(device, dtype) for t in (image, flow, cot)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,c,h,w,scale", [(2, 3, 5, 7, 4.0), (1, 17, 13, 33, 30.0), (2, 3, 2, 2, 1.5)]
)
def test_flow_warp_backward_kernel_any_shape(cuda, dtype, b, c, h, w, scale):
    image, flow, cot = _warp_bwd_case(b, c, h, w, scale, c + h, cuda, dtype)
    before = flow_warp_bwd.launches
    got = flow_warp_bwd(image, flow, cot)
    assert flow_warp_bwd.launches == before + 1
    want = flow_warp_backward_plain(image.float(), flow.float(), cot.float())
    for gt, wt, ref in zip(got, want, (image, flow)):
        assert gt.dtype == dtype and gt.shape == ref.shape
        _close("warp_bwd", gt, wt, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,scale", [(2, 3, 5, 7, 4.0), (1, 4, 17, 33, 30.0)])
def test_warp_blend_backward_kernel_any_shape(cuda, dtype, b, c, h, w, scale):
    prev, flow, cot = _warp_bwd_case(b, c, h, w, scale, h, cuda, dtype)
    g = torch.Generator().manual_seed(w)
    raw = torch.randn((b, c, h, w), generator=g).to(cuda, dtype)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g)).to(cuda, dtype)
    before = warp_blend_bwd.launches
    got = warp_blend_bwd(raw, prev, flow, weight, cot)
    assert warp_blend_bwd.launches == before + 1
    want = warp_blend_backward_plain(
        *(t.float() for t in (raw, prev, flow, weight, cot)))
    for gt, wt, ref in zip(got, want, (raw, prev, flow, weight)):
        assert gt.dtype == dtype and gt.shape == ref.shape
        _close("warp_bwd", gt, wt, dtype)


def test_warp_autograd_launches_the_backward_kernels(cuda):
    """torch.autograd through flow_warp and warp_blend on the card runs the
    backward kernels and gives the plain backward's gradients."""
    image, flow, cot = _warp_bwd_case(2, 3, 9, 11, 3.0, 7, cuda, torch.float32)
    raw, weight = torch.randn_like(image), torch.rand_like(image[:, :1])
    leaves = [t.clone().requires_grad_() for t in (raw, image, flow, weight)]
    before = (flow_warp_bwd.launches, warp_blend_bwd.launches)
    out = warp_blend(*leaves) + flow_warp(leaves[1], leaves[2])
    out.backward(cot)
    assert (flow_warp_bwd.launches, warp_blend_bwd.launches) == (before[0] + 1,
                                                                 before[1] + 1)
    d_raw, d_prev, d_flow, d_w = warp_blend_backward_plain(raw, image, flow, weight, cot)
    d_img2, d_flow2 = flow_warp_backward_plain(image, flow, cot)
    for leaf, want in zip(leaves, (d_raw, d_prev + d_img2, d_flow + d_flow2, d_w)):
        _close("warp_bwd", leaf.grad, want, torch.float32)


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    img = torch.zeros(1, 3, 6, 6, device=cuda)
    flow = torch.zeros(1, 2, 6, 6, device=cuda)
    with pytest.raises(ValueError, match="at least 2"):
        flow_warp_bwd(img[:, :, :1], flow[:, :, :1], img[:, :, :1])
    with pytest.raises(ValueError, match="dtype"):
        flow_warp_bwd(img, flow, img.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        warp_blend_bwd(img, img, flow, img[:, :1], img.transpose(2, 3))


@pytest.mark.parametrize(
    "b,c,h,w",
    [(2, 3, 7, 9), (1, 17, 13, 70), (2, 17, 1, 1), (1, 3, 45, 130), (1, 256, 8, 16)],
)
def test_correlation_kernel_any_shape(cuda, b, c, h, w):
    g = torch.Generator().manual_seed(c * 1000 + h * 10 + w)
    f1, f2 = (torch.randn((b, c, h, w), generator=g).to(cuda) for _ in range(2))
    before = correlation.launches
    got = correlation(f1, f2)
    assert correlation.launches == before + 1
    assert got.shape == (b, 441, h, w) and got.dtype == torch.float32
    _close("correlation", got, correlation_plain(f1, f2), torch.float32)


def test_new_kernels_reject_what_they_do_not_take(cuda):
    f = torch.zeros(1, 8, 6, 6, device=cuda)
    with pytest.raises(ValueError, match="not supported"):
        correlation(f.bfloat16(), f.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        correlation(f.transpose(2, 3), f)
    with pytest.raises(ValueError, match="cpu"):
        correlation(f, f.cpu())
    with pytest.raises(ValueError, match="max_displacement"):
        correlation(f, f, max_displacement=4, stride2=1)
    img = torch.zeros(1, 3, 6, 6, device=cuda)
    flow = torch.zeros(1, 2, 6, 6, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        flow_warp(img, flow.bfloat16())
    with pytest.raises(ValueError, match="not supported"):
        flow_warp(img.half(), flow.half())
    with pytest.raises(ValueError, match="contiguous"):
        flow_warp(img.transpose(2, 3), flow)
    with pytest.raises(ValueError, match="cpu"):
        flow_warp(img, flow.cpu())


def _conv_case(b, ci, co, h, w, k, seed, device, dtype):
    """(x, w, bias): x of (B, Ci, H, W), weights ~ 1/sqrt(k*k*ci)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, ci, h, w), generator=g)
    wt = torch.randn((co, ci, k, k), generator=g) / math.sqrt(k * k * ci)
    bias = torch.randn(co, generator=g)
    return x.to(device, dtype), wt.to(device, dtype), bias.to(device)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(1, 3, 3, 4, 4), (2, 5, 7, 13, 37), (1, 31, 64, 9, 70), (1, 80, 3, 17, 33),
     (2, 16, 16, 8, 32), (1, 35, 33, 11, 5)],
)
def test_conv7_kernel_any_shape(cuda, dtype, b, ci, co, h, w):
    x, wt, bias = _conv_case(b, ci, co, h, w, 7, ci * 100 + co, cuda, dtype)
    before = (conv7_reflect.launches, conv7_padded.launches)
    got = conv7_reflect(x, wt, bias)
    xp = torch.nn.functional.pad(x, (3, 3, 3, 3), mode="reflect")
    got_padded = conv7_padded(xp.contiguous(), wt)
    assert (conv7_reflect.launches, conv7_padded.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (b, co, h, w)
    _close("conv", got, conv7_reflect_plain(x.float(), wt.float(), bias), dtype)
    _close("conv", got_padded, conv7_plain(xp.float(), wt.float()), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,ci,co,h,w",
    # the last grid has 288 blocks: the three-blocks-per-SM instantiation
    [(1, 3, 5, 1, 1), (2, 17, 40, 9, 35), (1, 128, 128, 8, 32), (1, 64, 3, 5, 70),
     (2, 40, 36, 66, 250)],
)
def test_conv3_kernels_any_shape(cuda, dtype, b, ci, co, h, w):
    xp, wt, offset = _conv_case(b, ci, co, h + 2, w + 2, 3, ci + co + h, cuda, dtype)
    scale = 1.0 + 0.1 * offset.flip(0)
    residual = torch.randn((b, co, h, w), generator=torch.Generator().manual_seed(w))
    residual = residual.to(cuda, dtype)
    before = (conv3_padded.launches, conv3_fused_padded.launches)
    got = conv3_padded(xp, wt)
    assert got.dtype == dtype and got.shape == (b, co, h, w)
    _close("conv", got, conv3_plain(xp.float(), wt.float()), dtype)
    for res, relu in ((None, False), (None, True), (residual, False), (residual, True)):
        got = conv3_fused_padded(xp, wt, scale, offset, res, relu)
        want = conv3_fused_plain(xp.float(), wt.float(), scale, offset,
                                 None if res is None else res.float(), relu)
        _close("conv", got, want, dtype)
    assert (conv3_padded.launches, conv3_fused_padded.launches) == (before[0] + 1, before[1] + 4)


def test_conv_autograd_runs_the_plain_vjp(cuda):
    """The gradients of conv7_reflect / conv3_padded on the card are the
    plain version's, with the forward on the kernel."""
    x, wt, bias = _conv_case(2, 6, 5, 9, 12, 7, 3, cuda, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
    before = conv7_reflect.launches
    out = conv7_reflect(*leaves)
    assert conv7_reflect.launches == before + 1
    cot = torch.randn_like(out)
    out.backward(cot)
    ref =[t.clone().requires_grad_() for t in (x, wt, bias)]
    conv7_reflect_plain(*ref).backward(cot)
    for leaf, r in zip(leaves, ref):
        _close("conv", leaf.grad, r.grad, torch.float32)
    xp, w3, _ = _conv_case(1, 4, 6, 10, 11, 3, 4, cuda, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (xp, w3)]
    conv3_padded(*leaves).sum().backward()
    ref = [t.clone().requires_grad_() for t in (xp, w3)]
    conv3_plain(*ref).sum().backward()
    for leaf, r in zip(leaves, ref):
        _close("conv", leaf.grad, r.grad, torch.float32)


def test_conv_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 8, 8, device=cuda)
    w7 = torch.zeros(2, 4, 7, 7, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv7_reflect(x.transpose(2, 3), w7)
    with pytest.raises(ValueError, match="not supported"):
        conv7_reflect(x.half(), w7.half())
    with pytest.raises(ValueError, match="dtype"):
        conv7_reflect(x, w7, torch.zeros(2, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="H, W >= 4"):
        conv7_reflect(x[:, :, :3], w7)
    w3 = torch.zeros(2, 4, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="cpu"):
        conv3_padded(x, w3.cpu())
    ab = torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="residual"):
        conv3_fused_padded(x, w3, ab, ab, torch.zeros(1, 2, 8, 8, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        conv3_fused_padded(x, w3, ab.double(), ab)
