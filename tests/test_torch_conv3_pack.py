"""The bf16 3x3 body's packed weights (ops/conv3.py::pack_conv3_weight) and
the eval ResnetBlock's cache of them (nn/blocks.py), on CPU.

The packing is held entry by entry against OIHW, and the implicit GEMM the
tensor-core kernel runs on it (taps x 8-channel groups, K-major) is
emulated here and held against the JAX package's Pallas conv3 in interpret
mode (f32; atol 2e-4 + 1e-4 rel, as tests/test_torch_conv.py holds the
port's conv3 to it). The block's cached folded affines, weights and packed
weights must give bit for bit what folding them anew gives, and must be
rebuilt whenever a parameter, a norm buffer or the dtype changes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import nchw, nhwc
from vid2vid_tpu.ops import conv3_pallas as jc3
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import eval_affine
from vid2vid_tpu_torch.ops.conv3 import pack_conv3_weight, packed_shape
from vid2vid_tpu_torch.ops.conv7 import pack_for_kernel, pack_taps_3xtf32
from vid2vid_tpu_torch.ops.respair import respair_plain


@pytest.mark.parametrize("co,ci", [(1, 1), (3, 5), (8, 16), (12, 17), (40, 33), (130, 9)])
def test_pack_places_every_entry(co, ci):
    w = torch.arange(1, co * ci * 9 + 1, dtype=torch.float32).view(co, ci, 3, 3)
    got = pack_conv3_weight(w)
    assert tuple(got.shape) == packed_shape(co, ci)
    n_g, co_pad = got.shape[0], got.shape[2]
    assert n_g * 8 % 16 == 0 and n_g * 8 >= ci and co_pad % 8 == 0 and co_pad >= co
    want = np.zeros(got.shape, np.float32)
    wn = w.numpy()
    for g in range(n_g):
        for t in range(9):
            for o in range(co):
                for e in range(8):
                    if 8 * g + e < ci:
                        want[g, t, o, e] = wn[o, 8 * g + e, t // 3, t % 3]
    np.testing.assert_array_equal(got.numpy(), want)  # the padding is zero


def test_pack_keeps_dtype_and_is_contiguous():
    w = torch.randn(20, 24, 3, 3).bfloat16()
    got = pack_conv3_weight(w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got[1, 4, 7], w[7, 8:16, 1, 1])
    # the kernel's weight in either dtype: packed for the tensor cores
    # (bf16; f32 as 3xTF32), the only body of a 3x3 conv
    assert torch.equal(pack_for_kernel(w), got)
    wf = w.float()
    assert torch.equal(pack_for_kernel(wf), pack_taps_3xtf32(wf))


def gemm_from_packed(xp: torch.Tensor, packed: torch.Tensor, co: int) -> torch.Tensor:
    """The bf16 kernel's implicit GEMM, in f32 on the CPU: for each tap t the
    pre-padded input shifted by (t // 3, t % 3), 8 channels per group (zero
    past Ci), contracted with packed[:, t] over (group, channel)."""
    b, ci, hp, wp = xp.shape
    h, w = hp - 2, wp - 2
    n_g = packed.shape[0]
    x = F.pad(xp, (0, 0, 0, 0, 0, 8 * n_g - ci)).view(b, n_g, 8, hp, wp)
    out = 0
    for t in range(9):
        a = x[:, :, :, t // 3 : t // 3 + h, t % 3 : t % 3 + w]
        out = out + torch.einsum("bgehw,goe->bohw", a, packed[:, t])
    return out[:, :co]


@pytest.mark.parametrize("co", [12, 16])
def test_packed_gemm_matches_pallas_conv3(rng, co):
    xp = rng.standard_normal((2, 10, 34, 128)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, 128, co))).astype(np.float32)
    want = jc3.conv3_pallas_padded(jnp.asarray(xp), jnp.asarray(k), 8, 32, interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    got = gemm_from_packed(nchw(xp), pack_conv3_weight(w), co)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4, rtol=1e-4)


def _block(rng, c=12, norm="batch"):
    block = ResnetBlock(c, norm)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        for m in block.modules():
            if getattr(m, "running_mean", None) is not None:
                m.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return block.eval()


def _fresh(block, x):
    """respair_plain on the block's weights and affines folded anew."""
    blk, args = block.conv_block, []
    for conv, norm in ((blk[1], blk[2]), (blk[5], blk[6])):
        a, c = eval_affine(norm, block.dim, x.device)
        args += [conv.weight.to(x.dtype), (a, c + conv.bias.float() * a)]
    return respair_plain(x, *args)


def _x(rng, c=12, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal((2, c, 7, 9)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_resnet_block_cache_reused_while_nothing_changes(rng, norm):
    block, x = _block(rng, norm=norm), _x(rng)
    with torch.no_grad():
        got = block(x)
        cache = block._eval_cache
        again = block(x)
        assert block._eval_cache is cache
        assert torch.equal(got, _fresh(block, x)) and torch.equal(again, got)
    # on the CPU the bf16 kernel's packed weights are never made
    assert cache[1][4] is None


def test_resnet_block_cache_rebuilt_after_load_state_dict(rng):
    block, x = _block(rng), _x(rng)
    other = _block(rng)
    with torch.no_grad():
        before = block(x)
        cache = block._eval_cache
        block.load_state_dict(other.state_dict())
        got = block(x)
    assert block._eval_cache is not cache
    assert torch.equal(got, _fresh(block, x)) and not torch.equal(got, before)


@pytest.mark.parametrize("which", ["conv weight", "conv bias", "norm weight", "running_var",
                                   "running_mean"])
def test_resnet_block_cache_rebuilt_after_in_place_change(rng, which):
    block, x = _block(rng), _x(rng)
    blk = block.conv_block
    target = {"conv weight": blk[5].weight, "conv bias": blk[1].bias,
              "norm weight": blk[6].weight, "running_var": blk[2].running_var,
              "running_mean": blk[6].running_mean}[which]
    with torch.no_grad():
        before = block(x)
        cache = block._eval_cache
        target.mul_(1.5).add_(0.25)
        got = block(x)
    assert block._eval_cache is not cache
    assert torch.equal(got, _fresh(block, x)) and not torch.equal(got, before)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_resnet_block_cache_rebuilt_after_to_dtype(rng, dtype):
    block, x = _block(rng), _x(rng)
    with torch.no_grad():
        block(x)
        cache = block._eval_cache
        block.to(dtype)
        xd = x.to(dtype)
        got = block(xd)
    assert block._eval_cache is not cache
    assert got.dtype == dtype and torch.equal(got, _fresh(block, xd))


def test_resnet_block_with_gradients_folds_anew(rng):
    """With gradients on, the block folds on each call and the conv weights
    get their gradient through respair_plain."""
    block, x = _block(rng), _x(rng)
    block(x).square().sum().backward()
    assert block._eval_cache is None
    assert block.conv_block[1].weight.grad is not None
    assert float(block.conv_block[5].weight.grad.abs().sum()) > 0
