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

from vid2vid_tpu_torch.ops.correlation import correlation, correlation_plain
from vid2vid_tpu_torch.ops.respair import respair, respair_plain
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_plain,
    warp_blend,
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
    [(2, 3, 5, 7), (1, 17, 13, 37), (1, 40, 9, 33), (2, 96, 8, 32), (1, 33, 2, 2)],
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
