"""The f32 convs' 3xTF32 tensor-core form, on the CPU.

In f32 the port's conv body (csrc/conv_wgmma.cuh) splits every operand into
two tf32 parts, big = tf32(x) and small = tf32(x - big), and runs three
tf32 products per tap (A_small B_big + A_big B_small + A_big B_big). Held
here:
- the split (ops/conv7.py::split_tf32, which packs the weights and mirrors
  the kernel's `cvt.rna.tf32.f32` on the input), bit for bit against an
  independent emulation in float64 (round half away from zero on the
  magnitude, to 11 significant bits, or to multiples of 2**-136 below the
  normal range), and x - big - small within 2**-21 of |x| (or of 2**-137,
  half the tf32 quantum below the normal range, for the tiniest);
- the packed weights (pack_taps_3xtf32), entry by entry, for K = 3 and 7
  with ragged Ci and Co;
- the kernel's implicit GEMM emulated on the packed weights and the split
  input, against the JAX package at f32: the Pallas conv7 and conv3 and
  the whole-respair kernel in interpret mode. Tolerance atol 5e-5 + 1e-5
  rel: the split keeps each product to within ~2**-21 of its value, and
  at these shapes (up to 49 * 24 or 9 * 128 products of inputs ~N(0, 1)
  and weights ~0.05-0.1) the products' magnitudes sum to at most ~40, so
  ~2e-5 in the worst case, summed in another order than JAX's. A single
  TF32 pass (A_big B_big alone) misses by ~100x more, which the tests
  also show;
- the eval caches (ReflectConv7, ResnetBlock) keep the f32 packing and
  rebuild it when a weight, the bias or the dtype changes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import nchw, nhwc
from vid2vid_tpu.ops import conv3_pallas as jc3
from vid2vid_tpu.ops import conv7_pallas as jc7
from vid2vid_tpu.ops.respair_pallas import pad_respair, respair_pallas
from vid2vid_tpu_torch.nn import blocks, layers
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import ReflectConv7
from vid2vid_tpu_torch.ops.conv7 import (
    CUDA_CORES,
    TENSOR_CORES,
    conv7_body,
    forced_conv7_body,
    pack_for_kernel,
    pack_taps,
    pack_taps_3xtf32,
    packed_shape_for,
    split_tf32,
    taps_shape_3xtf32,
)

ATOL, RTOL = 5e-5, 1e-5


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """x rounded to tf32 in float64: to 11 significant bits (multiples of
    2**(e - 11) for |x| in [2**(e-1), 2**e)), or to multiples of 2**-136
    below the normal range, ties away from zero."""
    x = x.astype(np.float64)
    _, e = np.frexp(x)
    q = np.where(np.abs(x) < 2.0**-126, 2.0**-136, np.ldexp(1.0, e - 11))
    return np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q


def _values(rng) -> np.ndarray:
    normals = rng.standard_normal(4000)
    scales = 10.0 ** rng.uniform(-30, 30, 2000)
    subnormal = np.array([1e-45, 3e-42, 1.17e-38, 5.877e-39, -2.3e-40], np.float64)
    return np.concatenate([normals, normals[:2000] * scales, subnormal, [0.0, -0.0, 1e38,
                                                                         -3.1e37]])


def test_split_rounds_to_tf32_and_keeps_the_rest(rng):
    x = torch.from_numpy(_values(rng).astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    np.testing.assert_array_equal(big.numpy(), tf32_reference(x.numpy()).astype(np.float32))
    # within 2**-21 of |x|; where small falls below the normal range its
    # tf32 quantum is 2**-136 (f32's subnormal spacing times 2**13), so the
    # rest is then at most half of that
    rest = (x.double() - big.double() - small.double()).abs()
    bound = torch.maximum(2.0**-21 * x.double().abs(), torch.tensor(2.0**-137).double())
    assert bool((rest <= bound).all()), float((rest - bound).max())
    normal = x.abs() >= 2.0**-100
    assert bool((rest[normal] <= 2.0**-21 * x.double().abs()[normal]).all())
    # signed zeros stay signed zeros in both parts
    z = split_tf32(torch.tensor([0.0, -0.0]))
    assert torch.equal(torch.signbit(z[0]), torch.tensor([False, True]))


def test_split_rounds_ties_away_from_zero():
    # bit patterns of 1 + k * 2**-23: half of the dropped 2**13 range, just
    # below and just above it
    base = 0x3F800000
    bits = torch.tensor([base | 0x1000, base | 0x0FFF, base | 0x1001, base | 0x3000],
                        dtype=torch.int32)
    for sign in (1, -1):
        x = bits.view(torch.float32) * sign
        big = split_tf32(x)[0].view(torch.int32) & 0x7FFFFFFF
        assert big.tolist() == [base + 0x2000, base, base + 0x2000, base + 0x4000]


@pytest.mark.parametrize("k,co,ci", [(3, 5, 13), (3, 16, 8), (7, 3, 31), (7, 17, 6)])
def test_3xtf32_pack_places_every_entry(rng, k, co, ci):
    w = torch.from_numpy(rng.standard_normal((co, ci, k, k)).astype(np.float32))
    got = pack_taps_3xtf32(w)
    assert tuple(got.shape) == taps_shape_3xtf32(co, ci, k) == packed_shape_for(
        torch.float32, co, ci, k)
    assert got.dtype == torch.float32 and got.is_contiguous()
    n_g, co_pad = got.shape[0], got.shape[3]
    assert n_g * 4 % 8 == 0 and n_g * 4 >= ci and co_pad % 8 == 0 and co_pad >= co
    parts = [p.numpy() for p in split_tf32(w)]
    want = np.zeros(got.shape, np.float32)
    for g in range(n_g):
        for e in range(4):
            if 4 * g + e < ci:
                for p in range(2):
                    want[g, p, :, :co, e] = parts[p][:, 4 * g + e].reshape(co, k * k).T
    np.testing.assert_array_equal(got.numpy(), want)  # the padding is zero


def test_pack_for_kernel_by_dtype():
    w = torch.randn(6, 10, 3, 3)
    assert torch.equal(pack_for_kernel(w), pack_taps_3xtf32(w))
    assert torch.equal(pack_for_kernel(w.bfloat16()), pack_taps(w.bfloat16()))


@pytest.mark.parametrize("ci,co,body", [
    (31, 64, TENSOR_CORES), (16, 16, TENSOR_CORES), (35, 64, TENSOR_CORES),
    (35, 32, TENSOR_CORES), (80, 3, CUDA_CORES), (32, 3, CUDA_CORES), (3, 16, CUDA_CORES)])
def test_f32_body_rule_at_the_single_image_shapes(ci, co, body):
    """The fixed rule picks, at each f32 7x7 conv shape of the single-image
    paths, the body that won its same-run A/B on the H100 (PERF.md)."""
    assert conv7_body(torch.float32, ci, co) == body


def test_body_rule_and_its_override():
    assert conv7_body(torch.bfloat16, 80, 3) == TENSOR_CORES
    with forced_conv7_body(CUDA_CORES):
        assert conv7_body(torch.float32, 31, 64) == CUDA_CORES
        assert conv7_body(torch.bfloat16, 31, 64) == TENSOR_CORES
    with forced_conv7_body(TENSOR_CORES):
        assert conv7_body(torch.float32, 80, 3) == TENSOR_CORES
    assert conv7_body(torch.float32, 31, 64) == TENSOR_CORES
    assert conv7_body(torch.float32, 80, 3) == CUDA_CORES


def gemm_3xtf32(xp: torch.Tensor, packed: torch.Tensor, co: int, k: int,
                single_pass: bool = False) -> torch.Tensor:
    """The f32 kernel's implicit GEMM on the CPU: the pre-padded input split
    as the kernel splits it, 4 channels per group (zero past Ci); for each
    tap t it is shifted by (t // k, t % k) and contracted over (group,
    channel) with packed[:, part, t]: A_small B_big + A_big B_small +
    A_big B_big (single_pass: A_big B_big alone, one TF32 pass). Each
    product of two tf32 values is exact in f32."""
    b, ci, hp, wp = xp.shape
    h, w = hp - k + 1, wp - k + 1
    n_g = packed.shape[0]
    xs = [F.pad(p, (0, 0, 0, 0, 0, 4 * n_g - ci)).view(b, n_g, 4, hp, wp)
          for p in split_tf32(xp)]
    pairs = [(0, 0)] if single_pass else [(1, 0), (0, 1), (0, 0)]
    out = 0
    for t in range(k * k):
        for pa, pb in pairs:
            a = xs[pa][:, :, :, t // k : t // k + h, t % k : t % k + w]
            out = out + torch.einsum("bgehw,goe->bohw", a, packed[:, pb, t])
    return out[:, :co]


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(nhwc(got) - np.asarray(want)).max())


@pytest.mark.parametrize("b,ci,co", [(1, 6, 3), (2, 17, 16), (1, 24, 33)])
def test_3xtf32_gemm_matches_pallas_conv7(rng, b, ci, co):
    x = rng.standard_normal((b, 8, 64, ci)).astype(np.float32)
    k = (0.05 * rng.standard_normal((7, 7, ci, co))).astype(np.float32)
    xp = np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
    want = jc7.conv7_pallas_padded(jnp.asarray(xp), jnp.asarray(k), block_rows=8,
                                   block_cols=64, interpret=True)
    packed = pack_taps_3xtf32(_oihw(k))
    got = gemm_3xtf32(nchw(xp), packed, co, 7)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert _err(gemm_3xtf32(nchw(xp), packed, co, 7, single_pass=True), want) > 100 * _err(
        got, want)


@pytest.mark.parametrize("co", [12, 16])
def test_3xtf32_gemm_matches_pallas_conv3(rng, co):
    xp = rng.standard_normal((2, 10, 34, 128)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, 128, co))).astype(np.float32)
    want = jc3.conv3_pallas_padded(jnp.asarray(xp), jnp.asarray(k), 8, 32, interpret=True)
    got = gemm_3xtf32(nchw(xp), pack_taps_3xtf32(_oihw(k)), co, 3)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def respair_3xtf32(x, k0, ab0, k1, ab1, single_pass=False):
    """respair as the kernel runs it in f32: two reflect-padded 3xTF32 3x3
    GEMMs with the epilogues on the f32 accumulator (h stored in f32)."""
    def conv(v, k):
        vp = F.pad(v, (1, 1, 1, 1), mode="reflect")
        return gemm_3xtf32(vp, pack_taps_3xtf32(k), k.shape[0], 3, single_pass)

    (a0, c0), (a1, c1) = ((a.view(1, -1, 1, 1), c.view(1, -1, 1, 1)) for a, c in (ab0, ab1))
    h = torch.relu(conv(x, k0) * a0 + c0)
    return x + conv(h, k1) * a1 + c1


def test_3xtf32_respair_matches_pallas_respair(rng):
    c = 128
    x = rng.standard_normal((1, 16, 64, c)).astype(np.float32)
    k0, k1 = (0.1 * rng.standard_normal((3, 3, c, c)).astype(np.float32) for _ in range(2))
    ab0, ab1 = (tuple(rng.standard_normal((c,)).astype(np.float32) for _ in range(2))
                for _ in range(2))
    want = respair_pallas(pad_respair(jnp.asarray(x)), jnp.asarray(k0),
                          tuple(map(jnp.asarray, ab0)), jnp.asarray(k1),
                          tuple(map(jnp.asarray, ab1)), block_rows=16, block_cols=64,
                          interpret=True)
    args = (nchw(x), _oihw(k0), tuple(map(torch.from_numpy, ab0)), _oihw(k1),
            tuple(map(torch.from_numpy, ab1)))
    got = respair_3xtf32(*args)
    # two convs deep, the second on h ~ O(3): up to 4x the one-conv bound
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=4 * ATOL, rtol=RTOL)
    assert _err(respair_3xtf32(*args, single_pass=True), want) > 100 * _err(got, want)


@pytest.fixture
def packing_caches(monkeypatch):
    """The eval caches keep the tensor-core body's packing, as on the card
    (the CPU forward runs the plain versions, which ignore it)."""
    for mod in (layers, blocks):
        monkeypatch.setattr(mod, "packs_on", lambda x: True)


def _conv(rng, ci=12, co=12):
    conv = ReflectConv7(ci, co)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return conv.eval()


def _x(rng, ci=12):
    return torch.from_numpy(rng.standard_normal((2, ci, 9, 11)).astype(np.float32))


def test_reflect_conv7_caches_the_3xtf32_packing(rng, packing_caches):
    conv, x = _conv(rng), _x(rng)
    with torch.no_grad():
        conv(x)
        packed = conv._eval_cache[1][2]
        assert torch.equal(packed, pack_taps_3xtf32(conv.weight))
        conv(x)
        assert conv._eval_cache[1][2] is packed
        conv.weight.mul_(1.5)
        conv(x)
        assert conv._eval_cache[1][2] is not packed
        assert torch.equal(conv._eval_cache[1][2], pack_taps_3xtf32(conv.weight))
        packed = conv._eval_cache[1][2]
        conv.load_state_dict(_conv(rng).state_dict())
        conv(x)
        assert torch.equal(conv._eval_cache[1][2], pack_taps_3xtf32(conv.weight))
        conv.to(torch.bfloat16)
        conv(x.bfloat16())
        bf = conv._eval_cache[1][2]
        assert bf.dtype == torch.bfloat16 and torch.equal(bf, pack_taps(conv.weight))


@pytest.mark.parametrize("ci,co", [(12, 5), (3, 16)])
def test_reflect_conv7_packs_only_for_the_tensor_core_body(rng, packing_caches, ci, co):
    """An f32 7x7 that the rule sends to the CUDA cores (Co <= 8, Ci <= 4)
    caches no packed weight (its kernel reads OIHW); in bf16 it runs on the
    tensor cores and caches their packing."""
    conv, x = _conv(rng, ci, co), _x(rng, ci)
    with torch.no_grad():
        conv(x)
        assert conv._eval_cache[1][2] is None
        conv.to(torch.bfloat16)
        conv(x.bfloat16())
        assert torch.equal(conv._eval_cache[1][2], pack_taps(conv.weight))


def test_resnet_block_caches_the_3xtf32_packing(rng, packing_caches):
    block = ResnetBlock(12).eval()
    x = _x(rng)
    with torch.no_grad():
        block(x)
        k0, _, k1, _, packed = block._eval_cache[1]
        assert torch.equal(packed[0], pack_taps_3xtf32(k0))
        assert torch.equal(packed[1], pack_taps_3xtf32(k1))
        block(x)
        assert block._eval_cache[1][4] is packed
        block.conv_block[5].weight.add_(0.25)
        block(x)
        k1 = block._eval_cache[1][2]
        assert block._eval_cache[1][4] is not packed
        assert torch.equal(block._eval_cache[1][4][1], pack_taps_3xtf32(k1))
        block.to(torch.bfloat16)
        block(x.bfloat16())
        assert block._eval_cache[1][4][0].dtype == torch.bfloat16
