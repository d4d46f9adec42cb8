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

from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import ReflectConv7, eval_affine
from vid2vid_tpu_torch.ops.conv3 import (
    conv3_fused_padded,
    conv3_fused_plain,
    conv3_padded,
    conv3_plain,
    pack_conv3_weight,
)
from vid2vid_tpu_torch.ops.conv7 import (
    CUDA_CORES,
    TENSOR_CORES,
    conv7_padded,
    conv7_plain,
    conv7_reflect,
    conv7_reflect_plain,
    forced_conv7_body,
    pack_conv7_weight,
    pack_taps_3xtf32,
)
from vid2vid_tpu_torch.ops.correlation import (
    correlation,
    correlation_backward_plain,
    correlation_bwd,
    correlation_plain,
    correlation_plan,
)
from vid2vid_tpu_torch.ops.respair import respair, respair_plain
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_backward_plain,
    flow_warp_bwd,
    flow_warp_plain,
    MAX_BOX_BYTES,
    staged_tiles,
    tile_plan,
    warp_blend,
    warp_blend_at,
    warp_blend_at_backward_plain,
    warp_blend_at_bwd,
    warp_blend_at_plain,
    warp_blend_backward_plain,
    warp_blend_bwd,
    warp_blend_plain,
    warp_forward_cuda,
    warp_forward_plan,
)
from vid2vid_tpu_torch.tools.warp_plans import iid_flow, smooth_flow

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
    # both dtypes on the tensor-core body (f32 as 3xTF32); the last grid has
    # more blocks than two per SM of an H100
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,n", [(2, 3, 5, 14, 2), (1, 4, 17, 64, 4)])
def test_warp_blend_backward_kernel_at_a_column_offset(cuda, dtype, b, c, h, w, n):
    """v2v_warp_blend_bwd with Wp and x0 (training's model axis): each of n
    shards against its plain version; d_raw, d_flow and d_weight bit for
    bit with the unsharded call's columns, x0 = 0 with the whole width the
    unsharded call but for d_prev's atomics; the shards' d_prev (each over
    the whole frame) summed against the whole frame's in f32; and the
    autograd of warp_blend_at launches it."""
    prev, flow, cot = _warp_bwd_case(b, c, h, w, 6.0, h, cuda, dtype)
    g = torch.Generator().manual_seed(w)
    raw = torch.randn((b, c, h, w), generator=g).to(cuda, dtype)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g)).to(cuda, dtype)
    args = (raw, prev, flow, weight, cot)
    whole = warp_blend_bwd(*args)
    at0 = warp_blend_at_bwd(*args, 0)
    for k in (0, 2, 3):
        assert torch.equal(at0[k], whole[k])
    _close("warp_bwd", at0[1].float(), whole[1].float(), dtype)
    dprev = torch.zeros(prev.shape, device=cuda)
    sw = w // n
    for x0 in range(0, w, sw):
        local = [t[..., x0 : x0 + sw].contiguous() for t in (raw, flow, weight, cot)]
        before = warp_blend_at_bwd.launches
        got = warp_blend_at_bwd(local[0], prev, local[1], local[2], local[3], x0)
        assert warp_blend_at_bwd.launches == before + 1
        want = warp_blend_at_backward_plain(
            *(t.float() for t in (local[0], prev, local[1], local[2], local[3])), x0)
        for gt, wt, ref in zip(got, want, (local[0], prev, local[1], local[2])):
            assert gt.dtype == dtype and gt.shape == ref.shape
            _close("warp_bwd", gt, wt, dtype)
        for k in (0, 2, 3):
            assert torch.equal(got[k], whole[k][..., x0 : x0 + sw])
        dprev += got[1].float()
        leaves = [t.clone().requires_grad_() for t in (local[0], prev, local[1], local[2])]
        warp_blend_at(*leaves, x0).backward(local[3])
        assert warp_blend_at_bwd.launches == before + 2
    if dtype == torch.float32:
        _close("warp_bwd", dprev, whole[1], dtype)


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
    [(2, 3, 7, 9), (1, 17, 13, 70), (2, 17, 1, 1), (1, 3, 45, 130), (1, 256, 8, 16),
     # the tile's edges (ops/correlation.py::TILE_*): rows of a parity not a
     # multiple of TILE_ROWS, W not a multiple of TILE_X and odd, C = 1, C
     # not a multiple of TILE_CHUNK; then chip_smoke.py's CORR_SHAPES
     (1, 8, 9, 20), (2, 9, 22, 131), (1, 1, 5, 20), (2, 12, 16, 64),
     (2, 256, 128, 256), (2, 256, 64, 128), (2, 256, 32, 64)],
)
def test_correlation_kernel_any_shape(cuda, b, c, h, w):
    g = torch.Generator().manual_seed(c * 1000 + h * 10 + w)
    f1, f2 = (torch.randn((b, c, h, w), generator=g).to(cuda) for _ in range(2))
    before, second = correlation.launches, correlation.second_kernels
    got = correlation(f1, f2)
    assert correlation.launches == before + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert correlation.second_kernels == second + (correlation_plan(b, c, h, w, sms).split > 1)
    assert got.shape == (b, 441, h, w) and got.dtype == torch.float32
    _close("correlation", got, correlation_plain(f1, f2), torch.float32)


@pytest.mark.parametrize("b,c,h,w", [(2, 256, 32, 64), (1, 3, 45, 130), (2, 256, 128, 256)])
def test_correlation_is_the_same_bit_for_bit_from_run_to_run(cuda, b, c, h, w):
    """No atomics: the split channel sum (2, 256, 32, 64) is added in a fixed
    order, so two launches on the same inputs agree exactly."""
    g = torch.Generator().manual_seed(b + c + h + w)
    f1, f2 = (torch.randn((b, c, h, w), generator=g).to(cuda) for _ in range(2))
    first = correlation(f1, f2)
    torch.cuda.synchronize()
    assert torch.equal(first, correlation(f1, f2))


# (B, C, H, W) of the correlation backward: C below and off the kernel's
# 64-channel block, H and W smaller than the displacement, one pixel; the
# tile's edges (ops/correlation.py::BWD_*): C one past a block (65) and two
# blocks and a bit (130), H not a multiple of 2 * BWD_ROWS, W not a
# multiple of the 64-column tile with W % 4 == 0 (16-byte stores, 20 and
# 68) and odd (131); then FlowNetC's training shape (8, 256, 48, 64) and
# chip_smoke.py's CORR_SHAPES
CORR_BWD_SHAPES = [(2, 3, 7, 9), (1, 17, 13, 70), (2, 17, 1, 1), (1, 16, 9, 20),
                   (2, 9, 22, 131), (1, 1, 5, 20), (1, 70, 9, 66), (2, 65, 12, 20),
                   (2, 130, 19, 131), (1, 256, 47, 68), (8, 256, 48, 64),
                   (2, 256, 64, 128), (2, 256, 32, 64)]


def _corr_bwd_case(b, c, h, w, cuda):
    g = torch.Generator().manual_seed(c * 1000 + h * 10 + w)
    return [torch.randn(shape, generator=g).to(cuda)
            for shape in ((b, c, h, w), (b, c, h, w), (b, 441, h, w))]


@pytest.mark.parametrize("b,c,h,w", CORR_BWD_SHAPES)
def test_correlation_backward_kernel_any_shape(cuda, b, c, h, w):
    """One launch, both gradients f32 of f1's shape, within the forward's
    bound of the plain version's autograd."""
    f1, f2, cot = _corr_bwd_case(b, c, h, w, cuda)
    before = correlation_bwd.launches
    got = correlation_bwd(f1, f2, cot)
    assert correlation_bwd.launches == before + 1
    for gt, wt in zip(got, correlation_backward_plain(f1, f2, cot)):
        assert gt.shape == f1.shape and gt.dtype == torch.float32
        _close("correlation", gt, wt, torch.float32)


@pytest.mark.parametrize("b,c,h,w", [(8, 256, 48, 64), (1, 17, 13, 70), (2, 65, 12, 20)])
def test_correlation_backward_is_the_same_bit_for_bit_from_run_to_run(cuda, b, c, h, w):
    """No atomics: each element is summed by one thread in a fixed order."""
    args = _corr_bwd_case(b, c, h, w, cuda)
    first = correlation_bwd(*args)
    torch.cuda.synchronize()
    for a, b_ in zip(first, correlation_bwd(*args)):
        assert torch.equal(a, b_)


def test_correlation_gradient_runs_the_backward_kernel(cuda):
    """autograd through `correlation` on the card launches the backward
    kernel once, for a cotangent that is not contiguous too."""
    f1, f2, _ = _corr_bwd_case(2, 20, 11, 40, cuda)
    leaves = [t.clone().requires_grad_() for t in (f1, f2)]
    before = correlation_bwd.launches
    out = correlation(*leaves)
    cot = torch.randn((2, 11, 441, 40), device=cuda).transpose(1, 2)
    out.backward(cot)
    assert correlation_bwd.launches == before + 1
    for leaf, want in zip(leaves, correlation_backward_plain(f1, f2, cot)):
        _close("correlation", leaf.grad, want, torch.float32)


def test_correlation_backward_rejects_what_it_does_not_take(cuda):
    f1, f2, cot = _corr_bwd_case(1, 8, 6, 6, cuda)
    before = correlation_bwd.launches
    with pytest.raises(ValueError, match="not supported"):
        correlation_bwd(f1.bfloat16(), f2.bfloat16(), cot.bfloat16())
    with pytest.raises(ValueError, match="max_displacement"):
        correlation_bwd(f1, f2, torch.zeros((1, 81, 6, 6), device=cuda), 4, 1)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_bwd(f1, f2, cot.transpose(2, 3))
    with pytest.raises(ValueError, match="want"):
        correlation_bwd(f1, f2, cot[:, :440])
    assert correlation_bwd.launches == before


def _dirty_allocator(*tensors):
    """Fill the caching allocator's blocks of these tensors' sizes (f32 and
    in their own dtype) with NaN and free them, so the wrapper's torch.empty
    outputs and scratch start from garbage: a kernel entry that did not zero
    its splat would show it."""
    for t in tensors:
        for dtype in {t.dtype, torch.float32}:
            torch.full(t.shape, float("nan"), dtype=dtype, device=t.device)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_backward_entries_zero_their_splat_and_cast_it_themselves(cuda, dtype):
    """One wrapper call of each backward is one launch count (and, in bf16,
    one count of the splat's cast), returns its gradients in the input dtype (bf16 rounded by the entry, no cast by the
    caller) and matches the plain version although every buffer the wrapper
    takes from the allocator held NaN."""
    image, flow, cot = _warp_bwd_case(2, 3, 19, 37, 3.0, 5, cuda, dtype)
    g = torch.Generator().manual_seed(11)
    raw = torch.randn(image.shape, generator=g).to(cuda, dtype)
    weight = torch.sigmoid(torch.randn((2, 1, 19, 37), generator=g)).to(cuda, dtype)
    for fn, plain, args in (
            (flow_warp_bwd, flow_warp_backward_plain, (image, flow, cot)),
            (warp_blend_bwd, warp_blend_backward_plain, (raw, image, flow, weight, cot))):
        _dirty_allocator(*args)
        before, casts = fn.launches, fn.second_kernels
        got = fn(*args)
        assert fn.launches == before + 1
        assert fn.second_kernels == casts + (dtype == torch.bfloat16)
        want = plain(*(t.float() for t in args))
        for gt, wt, ref in zip(got, want, args):
            assert gt.dtype == dtype and gt.shape == ref.shape
            _close("warp_bwd", gt, wt, dtype)


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
    # both dtypes on the tensor-core body (f32 as 3xTF32); the last grid has
    # more blocks than two per SM of an H100
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


@pytest.mark.parametrize("op", ["respair", "conv3_fused", "correlation"])
def test_kernels_without_a_backward_carry_the_plain_gradient(cuda, op):
    """A CUDA input with requires_grad gets, with the forward on the
    kernel, the gradients of the plain version's autograd (these three ops
    once returned results without a grad_fn on the card)."""
    g = torch.Generator().manual_seed(11)
    if op == "respair":
        c = 12
        x = torch.randn((2, c, 9, 13), generator=g)
        k0, k1 = (torch.randn((c, c, 3, 3), generator=g) / math.sqrt(9 * c) for _ in range(2))
        aff = [torch.randn(c, generator=g) for _ in range(4)]
        args = [t.to(cuda) for t in (x, k0, *aff[:2], k1, *aff[2:])]
        fn = lambda x, k0, a0, c0, k1, a1, c1: respair(x, k0, (a0, c0), k1, (a1, c1))  # noqa: E731
        plain = lambda x, k0, a0, c0, k1, a1, c1: respair_plain(  # noqa: E731
            x, k0, (a0, c0), k1, (a1, c1))
        kernel, tol = respair, "respair"
    elif op == "conv3_fused":
        xp, wt, offset = _conv_case(2, 5, 6, 10, 11, 3, 12, cuda, torch.float32)
        res = torch.randn((2, 6, 8, 9), generator=g).to(cuda)
        args = [xp, wt, 1.0 + 0.1 * offset.flip(0), offset, res]
        fn = lambda *a: conv3_fused_padded(*a, relu=True)  # noqa: E731
        plain = lambda *a: conv3_fused_plain(*a, relu=True)  # noqa: E731
        kernel, tol = conv3_fused_padded, "conv"
    else:
        args = [torch.randn((2, 7, 9, 13), generator=g).to(cuda) for _ in range(2)]
        fn, plain, kernel, tol = correlation, correlation_plain, correlation, "correlation"
    leaves = [t.clone().requires_grad_() for t in args]
    before = kernel.launches
    out = fn(*leaves)
    assert kernel.launches == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g).to(cuda)
    out.backward(cot)
    ref = [t.clone().requires_grad_() for t in args]
    plain(*ref).backward(cot)
    for leaf, r in zip(leaves, ref):
        _close(tol, leaf.grad, r.grad, torch.float32)


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


# The bf16 3x3 body (csrc/conv_wgmma.cuh at K = 3) tiles 64 columns x 2 or 4 rows x
# 16..128 output channels and steps K by 16 input channels: channel counts
# that fill no step or tile, widths that are not a multiple of 64 (or of 8:
# the epilogue's element-by-element stores), H = 2 with reflect, B > 1,
# Co < 8, a second output-channel block of 8, and the two 2048-pixel
# shapes of the flagship frame (C = 512, 1024 at 32x64).
@pytest.mark.parametrize(
    "b,c,h,w",
    [(3, 20, 2, 70), (1, 5, 9, 130), (2, 136, 17, 64), (1, 24, 2, 2), (2, 40, 6, 13),
     (1, 512, 32, 64), (1, 1024, 32, 64)],
)
def test_respair_tensor_core_tiles(cuda, b, c, h, w):
    test_respair_kernel_any_shape(cuda, torch.bfloat16, b, c, h, w)


@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(2, 20, 5, 2, 70), (1, 9, 130, 7, 129), (3, 24, 12, 3, 10), (1, 7, 3, 1, 1),
     (1, 512, 512, 32, 64), (1, 1024, 1024, 32, 64)],
)
def test_conv3_tensor_core_tiles(cuda, b, ci, co, h, w):
    test_conv3_kernels_any_shape(cuda, torch.bfloat16, b, ci, co, h, w)


def test_respair_takes_packed_weights(cuda):
    """The packed weights a caller made once give the same bf16 block as
    the wrapper's own packing; a packed weight of another shape, or packed
    weights with f32, are refused."""
    g = torch.Generator().manual_seed(5)
    c = 24
    x = torch.randn((2, c, 9, 70), generator=g).to(cuda, torch.bfloat16)
    k0, k1 = ((torch.randn((c, c, 3, 3), generator=g) / math.sqrt(9 * c)).to(
        cuda, torch.bfloat16) for _ in range(2))
    ab = [tuple(torch.randn(c, generator=g).to(cuda) for _ in range(2)) for _ in range(2)]
    packed = (pack_conv3_weight(k0), pack_conv3_weight(k1))
    got = respair(x, k0, ab[0], k1, ab[1], packed=packed)
    assert torch.equal(got, respair(x, k0, ab[0], k1, ab[1]))
    with pytest.raises(ValueError, match="packed k1"):
        respair(x, k0, ab[0], k1, ab[1], packed=(packed[0], packed[1][:, :1].contiguous()))
    with pytest.raises(ValueError, match="bf16 kernel"):
        respair(x.float(), k0.float(), ab[0], k1.float(), ab[1], packed=packed)


def test_resnet_block_cache_on_the_card(cuda):
    """The eval bf16 ResnetBlock packs its weights once, and packs anew
    after load_state_dict; its output is the kernel's on freshly folded
    weights."""
    block = ResnetBlock(40).to(cuda).eval().to(torch.bfloat16)
    x = torch.randn((1, 40, 12, 66), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda, torch.bfloat16)

    def fresh():
        blk = block.conv_block
        args = []
        for conv, norm in ((blk[1], blk[2]), (blk[5], blk[6])):
            a, c = eval_affine(norm, 40, x.device)
            args += [conv.weight, (a, c + conv.bias.float() * a)]
        return respair(x, *args)

    with torch.no_grad():
        got = block(x)
        packed = block._eval_cache[1][4]
        assert packed is not None and torch.equal(got, fresh())
        block(x)
        assert block._eval_cache[1][4] is packed
        sd = {k: v * 2 if v.is_floating_point() else v for k, v in block.state_dict().items()}
        block.load_state_dict(sd)
        got = block(x)
        assert block._eval_cache[1][4] is not packed and torch.equal(got, fresh())


# The bf16 7x7 body (csrc/conv_wgmma.cuh at K = 7) tiles 64 columns x 4 or 8
# rows x 8, 16 or 32 output channels and steps K by 16 input channels: the
# composite's ragged channel counts (Ci = 6 frame stems, 108 label stems,
# Co = 1, 2, 3 heads), a Co past one tile of 32 (33, 128), widths that are
# not a multiple of 64 or 8 (a last tile of 1 or 2 columns, whose left
# neighbour reflects its right edge), H and W down to 4, B > 1; both the
# reflect and the pre-padded entry.
@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(1, 3, 1, 4, 4), (2, 6, 2, 5, 7), (1, 17, 3, 9, 70), (1, 108, 16, 12, 130),
     (2, 17, 33, 8, 66), (1, 6, 128, 17, 129), (1, 108, 128, 4, 200), (2, 3, 3, 33, 13)],
)
def test_conv7_tensor_core_tiles(cuda, b, ci, co, h, w):
    test_conv7_kernel_any_shape(cuda, torch.bfloat16, b, ci, co, h, w)


def test_conv7_takes_packed_weights(cuda):
    """Weights packed once by the caller give the wrapper's own result; a
    packed weight of another shape, or packed weights with f32, are
    refused."""
    x, wt, bias = _conv_case(2, 20, 12, 9, 70, 7, 5, cuda, torch.bfloat16)
    packed = pack_conv7_weight(wt)
    assert torch.equal(conv7_reflect(x, wt, bias, packed=packed), conv7_reflect(x, wt, bias))
    with pytest.raises(ValueError, match="packed"):
        conv7_reflect(x, wt, bias, packed=packed[:, :1].contiguous())
    with pytest.raises(ValueError, match="bf16 kernel"):
        conv7_reflect(x.float(), wt.float(), bias, packed=packed)


def test_reflect_conv7_cache_on_the_card(cuda):
    """The eval bf16 ReflectConv7 packs its weights once, and packs anew
    after load_state_dict; its output is the kernel's on fresh weights."""
    conv = ReflectConv7(24, 5).to(cuda).eval().to(torch.bfloat16)
    x = torch.randn((1, 24, 12, 66), generator=torch.Generator().manual_seed(2))
    x = x.to(cuda, torch.bfloat16)
    with torch.no_grad():
        got = conv(x)
        packed = conv._eval_cache[1][2]
        assert packed is not None
        assert torch.equal(got, conv7_reflect(x, conv.weight, conv.bias.float()))
        conv(x)
        assert conv._eval_cache[1][2] is packed
        conv.load_state_dict({k: v * 2 for k, v in conv.state_dict().items()})
        got = conv(x)
        assert conv._eval_cache[1][2] is not packed
        assert torch.equal(got, conv7_reflect(x, conv.weight, conv.bias.float()))


# The warp forward takes two adjacent pixels of a row per thread, with one
# a 16-byte load or store per stream where W is a multiple of 16 bytes and
# the operands are aligned, element by element otherwise: such a W and
# even and odd ones that are not, rows over several tiles, B = 2, and
# operands that start one element past an aligned address.
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w", [(2, 3, 7, 514), (2, 3, 7, 515), (1, 3, 5, 1026),
                                     (2, 1, 3, 2), (2, 3, 37, 512)])
def test_warp_kernels_vector_and_scalar_rows(cuda, dtype, b, c, h, w):
    test_warp_blend_kernel_any_shape(cuda, dtype, b, c, h, w, 6.0)
    test_flow_warp_kernel_any_shape(cuda, dtype, b, c, h, w, 6.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_warp_kernels_on_misaligned_operands(cuda, dtype):
    g = torch.Generator().manual_seed(3)
    b, c, h, w = 2, 3, 6, 70

    def shifted(shape, scale=1.0):
        """A contiguous tensor one element past the start of its storage."""
        flat = torch.empty(math.prod(shape) + 1, device=cuda, dtype=dtype)[1:]
        return flat.view(shape).copy_(scale * torch.randn(shape, generator=g))

    raw, prev = shifted((b, c, h, w)), shifted((b, c, h, w))
    flow, weight = shifted((b, 2, h, w), 5.0), shifted((b, 1, h, w)).sigmoid_()
    _close("warp", warp_blend(raw, prev, flow, weight),
           warp_blend_plain(*(t.float() for t in (raw, prev, flow, weight))), dtype)
    _close("warp", flow_warp(prev, flow), flow_warp_plain(prev.float(), flow.float()), dtype)


# The forward's two paths (csrc/warp_blend.cu): a tile whose box of prev
# fits the plan's budget is staged in shared memory, any other gathers from
# device memory. Flows that stage every tile (zero), none (60 px i.i.d.:
# every box spans most of the frame), a mix (smooth above, 60 px below),
# and a smooth one (8 px on a 1/16 grid, bilinearly upsampled: mostly
# staged); an aligned shape and ragged ones (W not a multiple of 16 bytes,
# odd H and W: element-by-element streams and copies).
def _forward_flows(b, h, w, g):
    smooth = smooth_flow(b, h, w, g)
    far = iid_flow(b, h, w, g, scale=60.0)
    return {"zero": torch.zeros(b, 2, h, w), "smooth": smooth, "far": far,
            "mix": torch.cat([smooth[:, :, : h // 2], far[:, :, h // 2 :]], 2)}


def _forward_paths(cuda, prev, flow, raw=None, weight=None, x0=-1):
    """(the staged tile, (out under it, its staged tiles, out under the
    direct tile, its staged tiles (0), out with every box that fits 226 KB
    staged, its staged tiles)), each one launch of the entry: the staged
    tile is warp_forward_plan's for large frames (tile_plan), forced here.
    The plan's own out, and the staged tile's with a budget under every box
    (each tile takes the staged kernel's direct branch), must equal them."""
    c, h, w = prev.shape[1], flow.shape[2], flow.shape[3]
    plan = tile_plan(prev.dtype, staged=True)
    outs = []
    for p in (plan, tile_plan(prev.dtype, staged=False),
              plan._replace(smem_bytes=MAX_BOX_BYTES)):
        staged = torch.zeros(1, dtype=torch.int32, device=cuda)
        outs += [warp_forward_cuda(prev, flow, raw, weight, x0, p, staged), int(staged)]
    assert outs[3] == 0
    staged = torch.zeros(1, dtype=torch.int32, device=cuda)
    under = warp_forward_cuda(prev, flow, raw, weight, x0, plan._replace(smem_bytes=1), staged)
    assert int(staged) == 0 and torch.equal(under, outs[0])
    own = warp_forward_plan(c, prev.dtype, h, w, prev.shape[3])
    assert torch.equal(warp_forward_cuda(prev, flow, raw, weight, x0, own), outs[0])
    return plan, outs


@pytest.mark.parametrize("kind", ["zero", "smooth", "far", "mix"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w", [(2, 3, 96, 320), (1, 3, 37, 150), (1, 1, 33, 131)])
def test_warp_forward_staged_and_direct_tiles(cuda, kind, dtype, b, c, h, w):
    """Both entries under the staged tile: held to the plain versions; the
    staged tiles those of staged_tiles; the staged path bit for bit with
    the direct tile (no budget), with every box that fits 226 KB staged,
    with no box staged, and with the plan's own tile."""
    g = torch.Generator().manual_seed(h + w)
    raw, prev = (torch.randn((b, c, h, w), generator=g) for _ in range(2))
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g))
    flow = _forward_flows(b, h, w, g)[kind]
    raw, prev, flow, weight = (t.to(cuda, dtype) for t in (raw, prev, flow, weight))
    for blend in (False, True):
        args = (raw, weight) if blend else (None, None)
        plan, (out, staged, direct, _, most, staged_most) = _forward_paths(
            cuda, prev, flow, *args)
        tiles = b * math.ceil(h / plan.rows) * math.ceil(w / plan.cols)
        want = (warp_blend_plain(raw.float(), prev.float(), flow.float(), weight.float())
                if blend else flow_warp_plain(prev.float(), flow.float()))
        _close("warp", out, want, dtype)
        assert staged == staged_tiles(flow, plan, c)
        assert staged_most == staged_tiles(flow, plan._replace(smem_bytes=MAX_BOX_BYTES), c)
        assert torch.equal(out, direct) and torch.equal(most, direct)
        if kind == "zero":
            assert staged == tiles
        if kind == "far" and (h, w) == (96, 320):
            assert staged == 0
        if kind == "mix" and (h, w) == (96, 320):
            assert 0 < staged < tiles


@pytest.mark.parametrize("x0", [0, 5, 64])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_warp_blend_forward_at_a_column_offset(cuda, dtype, x0):
    """The model axis's blend: 128 columns from column x0 of a frame 260
    wide (its rows 16-byte aligned in f32, not in bf16), a mixed flow:
    held to warp_blend_at_plain, the staged tiles those of staged_tiles,
    the staged path bit for bit with the direct one."""
    b, c, h, w, wp = 2, 3, 40, 128, 260
    g = torch.Generator().manual_seed(x0)
    prev = torch.randn((b, c, h, wp), generator=g)
    raw = torch.randn((b, c, h, w), generator=g)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=g))
    flow = _forward_flows(b, h, w, g)["mix"]
    raw, prev, flow, weight = (t.to(cuda, dtype) for t in (raw, prev, flow, weight))
    before = warp_blend_at.launches
    plan, (out, staged, direct, _, most, _) = _forward_paths(cuda, prev, flow, raw, weight, x0)
    assert warp_blend_at.launches == before + 5
    want = warp_blend_at_plain(*(t.float() for t in (raw, prev, flow, weight)), x0)
    _close("warp", out, want, dtype)
    assert staged == staged_tiles(flow, plan, c, wp, x0)
    assert torch.equal(out, direct) and torch.equal(most, direct)
    assert torch.equal(out, warp_blend_at(raw, prev, flow, weight, x0))


# The f32 body on the tensor cores (csrc/conv_wgmma.cuh as 3xTF32: 8-channel
# K steps of two 4-channel groups, each operand in two tf32 parts; 3x3
# tiles of 64 columns x 2 or 4 rows x 16..128 channels, 7x7 tiles of 64 x 4
# x 8..32): Ci not a multiple of 4 or 8, Co < 8 and past one tile, H = 2
# with reflect, widths that are not a multiple of 64, 8 or 4 (the input
# staged by cp.asyncs of 8 or 4 bytes, the epilogue's element-by-element
# stores), B > 1, and the single-image paths' shapes (respair: C = 528 at
# 64x64 on edge2face, C = 1024 at 32x64 and C = 64 at 512x1024 on the
# LocalEnhancer; conv7: the stems and heads of both paths).
@pytest.mark.parametrize(
    "b,c,h,w",
    [(3, 20, 2, 70), (1, 5, 9, 130), (2, 13, 17, 64), (1, 6, 2, 2), (2, 40, 6, 13),
     (1, 136, 9, 66), (1, 528, 64, 64), (1, 1024, 32, 64), (1, 64, 512, 1024)],
)
def test_respair_f32_tensor_core_tiles(cuda, b, c, h, w):
    test_respair_kernel_any_shape(cuda, torch.float32, b, c, h, w)


@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(2, 20, 5, 2, 70), (1, 9, 130, 7, 129), (3, 6, 12, 3, 10), (1, 7, 3, 1, 1),
     (1, 528, 528, 64, 64)],
)
def test_conv3_f32_tensor_core_tiles(cuda, b, ci, co, h, w):
    test_conv3_kernels_any_shape(cuda, torch.float32, b, ci, co, h, w)


@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(1, 3, 1, 4, 4), (2, 6, 2, 5, 7), (1, 17, 3, 9, 70), (1, 13, 16, 12, 130),
     (2, 17, 33, 8, 66), (1, 6, 40, 17, 129), (2, 3, 3, 33, 13), (1, 31, 64, 512, 512),
     (1, 80, 3, 512, 512), (1, 3, 16, 512, 512), (1, 16, 16, 512, 512),
     (1, 35, 64, 512, 1024), (1, 35, 32, 1024, 2048), (1, 32, 3, 1024, 2048)],
)
def test_conv7_f32_tensor_core_tiles(cuda, b, ci, co, h, w):
    with forced_conv7_body(TENSOR_CORES):
        test_conv7_kernel_any_shape(cuda, torch.float32, b, ci, co, h, w)


@pytest.mark.parametrize(
    "b,ci,co,h,w",
    [(1, 3, 3, 4, 4), (2, 5, 7, 13, 37), (1, 80, 3, 17, 33), (1, 31, 64, 9, 70)],
)
def test_f32_cuda_core_body_any_shape(cuda, b, ci, co, h, w):
    """The f32 7x7 on the CUDA-core body (csrc/conv_kxk.cuh), forced, at
    the any-shape cases, as the tensor-core body takes them above."""
    with forced_conv7_body(CUDA_CORES):
        test_conv7_kernel_any_shape(cuda, torch.float32, b, ci, co, h, w)


def test_f32_bodies_agree(cuda):
    """The f32 respair (3xTF32 on the tensor cores) and the f32 7x7 on
    both bodies, forced in turn, give results within the f32 tolerance of
    the plain version, and the tensor cores' within 1e-4 (no single TF32
    pass: that would miss the plain version by ~1e-3 here)."""
    x, k0, ab0, k1, ab1 = _respair_case(2, 96, 20, 70, cuda)
    xc, wc, bias = _conv_case(2, 31, 16, 20, 70, 7, 9, cuda, torch.float32)
    want = respair_plain(x, k0, ab0, k1, ab1), conv7_reflect_plain(xc, wc, bias)
    got = respair(x, k0, ab0, k1, ab1)
    _close("respair", got, want[0], torch.float32)
    errs = [float((got - want[0]).abs().max())]
    for body in (TENSOR_CORES, CUDA_CORES):
        with forced_conv7_body(body):
            got = conv7_reflect(xc, wc, bias)
        _close("conv", got, want[1], torch.float32)
        if body == TENSOR_CORES:
            errs.append(float((got - want[1]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_f32_tensor_core_conv7_carries_the_plain_gradient(cuda):
    """An f32 conv7 on the tensor-core body (16 -> 16: the rule's pick)
    with inputs requiring grad: the forward on the kernel, the gradients
    of the plain version's autograd."""
    x, wt, bias = _conv_case(2, 16, 16, 9, 70, 7, 21, cuda, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
    before = conv7_reflect.launches
    out = conv7_reflect(*leaves)
    assert conv7_reflect.launches == before + 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    out.backward(cot)
    ref = [t.clone().requires_grad_() for t in (x, wt, bias)]
    conv7_reflect_plain(*ref).backward(cot)
    for leaf, r in zip(leaves, ref):
        _close("conv", leaf.grad, r.grad, torch.float32)


def _respair_case(b, c, h, w, device):
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn((b, c, h, w), generator=g)
    k0, k1 = (torch.randn((c, c, 3, 3), generator=g) / math.sqrt(9 * c) for _ in range(2))
    ab = [tuple(torch.randn(c, generator=g).to(device) for _ in range(2)) for _ in range(2)]
    return x.to(device), k0.to(device), ab[0], k1.to(device), ab[1]


def test_f32_kernels_take_3xtf32_packed_weights(cuda):
    """Weights packed once by the caller (pack_taps_3xtf32) give the
    wrapper's own result; packed weights of another shape, or of the bf16
    body, are refused."""
    x, k0, ab0, k1, ab1 = _respair_case(2, 24, 9, 70, cuda)
    packed = (pack_taps_3xtf32(k0), pack_taps_3xtf32(k1))
    got = respair(x, k0, ab0, k1, ab1, packed=packed)
    assert torch.equal(got, respair(x, k0, ab0, k1, ab1))
    with pytest.raises(ValueError, match="packed k1"):
        respair(x, k0, ab0, k1, ab1, packed=(packed[0], packed[1][:, :, :1].contiguous()))
    with pytest.raises(ValueError, match="bf16 kernel"):
        respair(x, k0, ab0, k1, ab1, packed=(pack_conv3_weight(k0.bfloat16()),) * 2)
    with pytest.raises(ValueError, match="3xTF32"):
        respair(x.bfloat16(), k0.bfloat16(), ab0, k1.bfloat16(), ab1, packed=packed)
    xc, wc, bias = _conv_case(2, 20, 12, 9, 70, 7, 5, cuda, torch.float32)
    packed7 = pack_taps_3xtf32(wc)
    assert torch.equal(conv7_reflect(xc, wc, bias, packed=packed7), conv7_reflect(xc, wc, bias))
    with pytest.raises(ValueError, match="packed"):
        conv7_reflect(xc, wc, bias, packed=packed7[:, :, :1].contiguous())


def test_f32_tensor_cores_raise_rather_than_fall_back(cuda):
    """A case the tensor-core body cannot take (packed weights that are not
    16-byte aligned: its tensor map needs them so) raises on the card; no
    other body runs in its place."""
    x, k0, ab0, k1, ab1 = _respair_case(1, 24, 9, 70, cuda)
    packed = pack_taps_3xtf32(k0)
    flat = torch.empty(packed.numel() + 1, device=cuda)[1:]
    shifted = flat.view(packed.shape).copy_(packed)
    before = respair.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        respair(x, k0, ab0, k1, ab1, packed=(shifted, shifted))
    assert respair.launches == before


def test_f32_caches_on_the_card(cuda):
    """The eval f32 ResnetBlock and ReflectConv7 pack their weights for the
    3xTF32 body once, and anew after load_state_dict; their output is the
    kernel's on freshly made weights. A ReflectConv7 that the rule sends to
    the CUDA cores (Co <= 8) caches no packing."""
    block = ResnetBlock(40).to(cuda).eval()
    conv = ReflectConv7(24, 12).to(cuda).eval()
    x = torch.randn((1, 40, 12, 66), generator=torch.Generator().manual_seed(1)).to(cuda)
    xc = x[:, :24].contiguous()

    def fresh():
        blk = block.conv_block
        args = []
        for cv, norm in ((blk[1], blk[2]), (blk[5], blk[6])):
            a, c = eval_affine(norm, 40, x.device)
            args += [cv.weight, (a, c + cv.bias.float() * a)]
        return respair(x, *args), conv7_reflect(xc, conv.weight, conv.bias)

    with torch.no_grad():
        got = block(x), conv(xc)
        packed = block._eval_cache[1][4], conv._eval_cache[1][2]
        assert packed[0][0].dtype == torch.float32
        assert torch.equal(packed[0][0], pack_taps_3xtf32(block.conv_block[1].weight))
        assert torch.equal(packed[1], pack_taps_3xtf32(conv.weight))
        want = fresh()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        head = ReflectConv7(24, 5).to(cuda).eval()
        assert torch.equal(head(xc), conv7_reflect(xc, head.weight, head.bias))
        assert head._eval_cache[1][2] is None
        block(x), conv(xc)
        assert block._eval_cache[1][4] is packed[0] and conv._eval_cache[1][2] is packed[1]
        for mod in (block, conv):
            mod.load_state_dict({k: v * 2 if v.is_floating_point() else v
                                 for k, v in mod.state_dict().items()})
        got = block(x), conv(xc)
        assert block._eval_cache[1][4] is not packed[0]
        assert conv._eval_cache[1][2] is not packed[1]
        want = fresh()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_served_ops_launch_their_kernels(cuda):
    """torch.ops.v2v.respair / conv7 / warp_blend on CUDA tensors launch the
    kernels (one count each), equal the wrappers bit for bit, and pass
    torch.library.opcheck there (its fake and dispatch checks)."""
    from vid2vid_tpu_torch.ops.library import served_ops

    ops = served_ops()
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(cuda)

    x, k0, k1 = randn(1, 32, 12, 20), 0.1 * randn(32, 32, 3, 3), 0.1 * randn(32, 32, 3, 3)
    a, c = randn(32).abs() + 0.5, randn(32)
    w, bias = 0.05 * randn(16, 32, 7, 7), randn(16)
    prev, flow = randn(1, 3, 12, 20), 3 * randn(1, 2, 12, 20)
    raw, weight = randn(1, 3, 12, 20), randn(1, 1, 12, 20).sigmoid()
    for dtype in DTYPES:
        xd, k0d, k1d, wd = (t.to(dtype) for t in (x, k0, k1, w))
        cases = [
            ("respair", respair, (xd, k0d, a, c, k1d, a, c, None, None),
             lambda: respair(xd, k0d, (a, c), k1d, (a, c))),
            ("conv7", conv7_reflect, (xd, wd, bias, None, True),
             lambda: conv7_reflect(xd, wd, bias)),
            ("warp_blend", warp_blend, tuple(t.to(dtype) for t in (raw, prev, flow, weight)),
             lambda: warp_blend(*(t.to(dtype) for t in (raw, prev, flow, weight)))),
        ]
        for name, wrapper, args, via_wrapper in cases:
            before = wrapper.launches
            got = ops[name](*args)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1, name
            assert torch.equal(got, via_wrapper()), name
            torch.library.opcheck(ops[name], args, test_utils=("test_schema", "test_faketensor"))


def test_exported_step_on_the_card(cuda, tmp_path):
    """tools/export.py on the card at a small size: the loaded artifact
    launches the kernels and equals InferenceEngine.step bit for bit."""
    from vid2vid_tpu_torch.config import Options
    from vid2vid_tpu_torch.models.inference import InferenceEngine
    from vid2vid_tpu_torch.nn.layers import init_weights
    from vid2vid_tpu_torch.tools import export

    opt = Options(label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=32,
                  n_downsample_G=2, n_blocks=3, n_blocks_local=1, n_scales_spatial=2,
                  n_frames_G=3, norm="batch", bf16=True, isTrain=False)
    eng = InferenceEngine(opt)
    init_weights(eng.gen, torch.Generator().manual_seed(0))
    export.save_exported(str(tmp_path), opt, eng, 1, 64, 128)
    step = export.load_exported(str(tmp_path), "cuda")
    gen = torch.Generator().manual_seed(1)
    labels = torch.randint(0, 4, (1, 4, 64, 128), generator=gen)
    inst = torch.randint(0, 3, (1, 4, 64, 128), generator=gen)
    state, state_ref = None, eng.initial_state(1, 64, 128)
    for t in range(2):
        before = (respair.launches, conv7_reflect.launches, warp_blend.launches)
        got, state = step(labels[:, t : t + 3], inst[:, t : t + 3], state)
        torch.cuda.synchronize()
        after = (respair.launches, conv7_reflect.launches, warp_blend.launches)
        assert all(b < a for b, a in zip(before, after))
        want, state_ref = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state_ref)
        assert torch.equal(got, want)
        assert all(torch.equal(s, r) for s, r in zip(state, state_ref))


def test_one_rank_over_nccl_equals_the_plain_trainer(cuda):
    """parallel.launch with one rank over NCCL on the card: two training
    chunks give the plain Trainer's losses and weights, bit for bit (both
    under deterministic algorithms: two plain runs differ without them)."""
    import functools

    import numpy as np

    import torch_ranks

    from vid2vid_tpu_torch.parallel import launch

    cfg = dict(label_nc=4, use_instance=False, output_nc=3, ngf=8, n_downsample_G=2,
               n_blocks=1, n_scales_spatial=1, n_frames_G=3, n_frames_D=3,
               n_scales_temporal=1, ndf=8, num_D=1, n_layers_D=2, n_frames_total=6,
               max_frames_per_gpu=3, norm="batch", no_vgg=True, isTrain=True, fineSize=64)
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 4, (1, 8, 32, 64)).astype(np.int32)
    frames = rng.uniform(-1, 1, (1, 8, 3, 32, 64)).astype(np.float32)
    run = functools.partial(torch_ranks.train_chunks, cfg, labels, frames, n_load=3,
                            device="cuda:0", deterministic=True)
    (rank,) = launch(run, 1, devices=["cuda:0"], backend="nccl", deadline_s=300)
    plain = run()
    assert rank["losses"] == plain["losses"]
    assert rank["digests"] == plain["digests"]
