"""The bf16 7x7 body's packed weights (ops/conv7.py::pack_conv7_weight), the
eval ReflectConv7's cache of them (nn/layers.py) and the composite
generators' route through it, on CPU.

The packing is held entry by entry against OIHW at the composite's ragged
channel counts, and the implicit GEMM the tensor-core kernel runs on it
(49 taps x 8-channel groups, K-major) is emulated here and held against
the JAX package's Pallas conv7 in interpret mode (f32; atol 2e-5 + 1e-5
rel: the same products summed in another order). The conv's cached
weights must give bit for bit what they give made anew, and be rebuilt
whenever the weight, the bias or the dtype changes. The composites keep
the reference's state-dict names with every 7x7 stem and head routed
through conv7 (tests/test_torch_nn.py and test_torch_inference.py hold
their outputs to the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import nchw, nhwc
from vid2vid_tpu.ops import conv7_pallas as jc7
from vid2vid_tpu.utils.torch_import import composite_generator_mapping, composite_local_mapping
from vid2vid_tpu_torch.nn.composite import CompositeGenerator, CompositeLocalGenerator
from vid2vid_tpu_torch.nn.layers import FoldedReflectionPad2d, ReflectConv7
from vid2vid_tpu_torch.ops.conv7 import conv7_reflect_plain, pack_conv7_weight, taps_shape


@pytest.mark.parametrize("co,ci", [(1, 6), (3, 32), (16, 108), (2, 1), (33, 17)])
def test_pack_places_every_entry(co, ci):
    w = torch.arange(1, co * ci * 49 + 1, dtype=torch.float32).view(co, ci, 7, 7)
    got = pack_conv7_weight(w)
    assert tuple(got.shape) == taps_shape(co, ci, 7)
    n_g, co_pad = got.shape[0], got.shape[2]
    assert n_g * 8 % 16 == 0 and n_g * 8 >= ci and co_pad % 8 == 0 and co_pad >= co
    want = np.zeros(got.shape, np.float32)
    wn = w.numpy()
    for g in range(n_g):
        for e in range(8):
            if 8 * g + e < ci:
                want[g, :, :co, e] = wn[:, 8 * g + e].reshape(co, 49).T
    np.testing.assert_array_equal(got.numpy(), want)  # the padding is zero


def test_pack_keeps_dtype_and_rejects_other_kernels():
    w = torch.randn(20, 24, 7, 7).bfloat16()
    got = pack_conv7_weight(w)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got[1, 7 * 3 + 4, 9], w[9, 8:16, 3, 4])
    with pytest.raises(ValueError, match="7, 7"):
        pack_conv7_weight(torch.zeros(4, 4, 3, 3))


def gemm_from_packed(xp: torch.Tensor, packed: torch.Tensor, co: int) -> torch.Tensor:
    """The bf16 kernel's implicit GEMM, in f32 on the CPU: for each tap t the
    pre-padded input shifted by (t // 7, t % 7), 8 channels per group (zero
    past Ci), contracted with packed[:, t] over (group, channel)."""
    b, ci, hp, wp = xp.shape
    h, w = hp - 6, wp - 6
    n_g = packed.shape[0]
    x = F.pad(xp, (0, 0, 0, 0, 0, 8 * n_g - ci)).view(b, n_g, 8, hp, wp)
    out = 0
    for t in range(49):
        a = x[:, :, :, t // 7 : t // 7 + h, t % 7 : t % 7 + w]
        out = out + torch.einsum("bgehw,goe->bohw", a, packed[:, t])
    return out[:, :co]


@pytest.mark.parametrize("b,ci,co", [(1, 6, 3), (2, 17, 16)])
def test_packed_gemm_matches_pallas_conv7(rng, b, ci, co):
    x = rng.standard_normal((b, 8, 64, ci)).astype(np.float32)
    k = (0.05 * rng.standard_normal((7, 7, ci, co))).astype(np.float32)
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    want = jc7.conv7_pallas_padded(jnp.asarray(xp), jnp.asarray(k), block_rows=8,
                                   block_cols=64, interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    got = gemm_from_packed(nchw(xp), pack_conv7_weight(w), co)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5, rtol=1e-5)


def _conv(rng, ci=12, co=5):
    conv = ReflectConv7(ci, co)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return conv.eval()


def _x(rng, ci=12, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal((2, ci, 9, 11)).astype(np.float32)).to(dtype)


def _fresh(conv, x):
    return conv7_reflect_plain(x, conv.weight.to(x.dtype), conv.bias.float())


def test_reflect_conv7_cache_reused_while_nothing_changes(rng):
    conv, x = _conv(rng), _x(rng)
    with torch.no_grad():
        got = conv(x)
        cache = conv._eval_cache
        again = conv(x)
        assert conv._eval_cache is cache
    assert torch.equal(got, _fresh(conv, x)) and torch.equal(again, got)
    assert cache[1][2] is None  # on the CPU the bf16 kernel's packing is never made


def test_reflect_conv7_cache_rebuilt_after_load_state_dict(rng):
    conv, x = _conv(rng), _x(rng)
    with torch.no_grad():
        before = conv(x)
        cache = conv._eval_cache
        conv.load_state_dict(_conv(rng).state_dict())
        got = conv(x)
    assert conv._eval_cache is not cache
    assert torch.equal(got, _fresh(conv, x)) and not torch.equal(got, before)


@pytest.mark.parametrize("which", ["weight", "bias"])
def test_reflect_conv7_cache_rebuilt_after_in_place_change(rng, which):
    conv, x = _conv(rng), _x(rng)
    with torch.no_grad():
        before = conv(x)
        cache = conv._eval_cache
        getattr(conv, which).mul_(1.5).add_(0.25)
        got = conv(x)
    assert conv._eval_cache is not cache
    assert torch.equal(got, _fresh(conv, x)) and not torch.equal(got, before)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_reflect_conv7_cache_rebuilt_after_to_dtype(rng, dtype):
    conv, x = _conv(rng), _x(rng)
    with torch.no_grad():
        conv(x)
        cache = conv._eval_cache
        conv.to(dtype)
        xd = x.to(dtype)
        got = conv(xd)
    assert conv._eval_cache is not cache
    assert got.dtype == dtype and torch.equal(got, _fresh(conv, xd))


def test_reflect_conv7_with_gradients_makes_its_arguments_anew(rng):
    conv, x = _conv(rng), _x(rng)
    conv(x).square().sum().backward()
    assert conv._eval_cache is None and float(conv.weight.grad.abs().sum()) > 0


def _routed(mod, names):
    """The routed 7x7 convs of `mod`, by their Sequential's name: each the
    pad / conv pair of the reference's ReflectionPad2d(3) + Conv2d(7)."""
    found = {}
    for name in names:
        seq = getattr(mod, name)
        pairs = [(seq[i], seq[i + 1]) for i in range(len(seq) - 1)
                 if isinstance(seq[i + 1], ReflectConv7)]
        assert len(pairs) == 1 and isinstance(pairs[0][0], FoldedReflectionPad2d), name
        found[name] = pairs[0][1]
    assert sum(isinstance(m, ReflectConv7) for m in mod.modules()) == len(names)
    return found


def _names(mapping) -> set:
    """The torch keys of a torch_import mapping (a tuple key is a JAX conv
    split in two: the flow and weight heads)."""
    keys = set()
    for k, _, _ in mapping:
        keys |= set(k) if isinstance(k, tuple) else {k}
    return keys


def _state_names(mod) -> set:
    return {k for k in mod.state_dict() if not k.endswith("num_batches_tracked")}


def test_composites_route_every_7x7_with_the_reference_names():
    """CompositeGenerator and CompositeLocalGenerator run all 7 stems and
    heads through conv7 in eval mode and keep the state-dict names of the
    JAX package's import mapping (the reference's checkpoint names)."""
    names = ["model_down_seg", "model_down_img", "indv_down", "model_final_img",
             "model_final_flow", "model_final_w", "indv_final"]
    g0 = CompositeGenerator(9, 6, ngf=8, n_downsampling=2, n_blocks=3, use_fg=True)
    convs = _routed(g0, names)
    assert convs["model_down_seg"].in_channels == 9 and convs["model_final_w"].out_channels == 1
    assert _state_names(g0) == _names(composite_generator_mapping(2, 3, "batch", True, False))
    g1 = CompositeLocalGenerator(9, 6, ngf=8, n_blocks_local=2, n_downsample_g=3,
                                 scale=1, use_fg=True)
    _routed(g1, names)
    assert _state_names(g1) == _names(composite_local_mapping(2, "batch", True, False))
