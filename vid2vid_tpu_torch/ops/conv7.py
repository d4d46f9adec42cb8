"""The 7x7 stride-1 conv as one op (the port of ops/conv7_pallas.py).

    conv7_padded(xp, w, bias)  = conv2d(xp, w) + bias        (VALID)
    conv7_reflect(x, w, bias)  = conv2d(reflect_pad(x, 3), w) + bias

NCHW inputs and OIHW weights, as nn.Conv2d holds them; the bias is
optional. Both call the operator `torch.ops.v2v.conv7` (ops/library.py),
which dispatches on the device: a CUDA tensor launches the hand-written
kernel (csrc/conv.cu::v2v_conv7: f32 or bf16, f32 accumulation, the
reflect pad folded into the load addressing, any shape) or raises; a CPU
tensor runs `conv7_plain`, which is also the kernel's oracle. In bf16 the kernel
runs on the tensor cores (csrc/conv_wgmma.cuh with K = 7) and takes the
weights in the layout of `pack_conv7_weight`: a caller that runs the conv
often packs them once and passes them as `packed` (nn/layers.py::
ReflectConv7); otherwise they are packed on each call. Unlike the TPU
entry point no shape rule here picks between kernel and conv: the Pallas
dispatch (`on_tpu`, h*w >= 256**2, `_pick_blocks`) is a Mosaic tiling
constraint. The gradient is the plain version's autograd, as the JAX
backward is the XLA conv's VJP.

`conv7_halo` is the kernel's column-halo mode for a width shard (the
model axis, parallel/halo.py): the input carries the neighbours' columns
on its inner sides and is reflected only at the image's edges;
`conv7_halo_plain` is its plain version.

In f32 the kernel runs on the tensor cores as 3xTF32 (`pack_taps_3xtf32`
is that body's weight layout, two tf32 parts of each weight) or, for the
narrow shapes where `conv7_body`'s fixed rule picks them, on the CUDA cores
(OIHW weights).

`plain_vjp`, `wants_grad`, `pack_taps` and `pack_taps_3xtf32` serve the
other conv wrappers too.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops import library
from vid2vid_tpu_torch.parallel.halo import BOTH_EDGES, LEFT_EDGE, RIGHT_EDGE, columns

K = 7
PAD = K // 2


def conv7_plain(
    xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """VALID 7x7 conv of a pre-padded input in plain PyTorch, in xp's dtype
    (the card's callers run it in f32 with TF32 off)."""
    dt = xp.dtype
    return F.conv2d(xp, w.to(dt), None if bias is None else bias.to(dt))


def conv7_reflect_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """ReflectionPad(3) + conv7_plain."""
    return conv7_plain(F.pad(x, (PAD,) * 4, mode="reflect"), w, bias)


def conv7_halo_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, xoff: int, width: int,
    edges: int,
) -> torch.Tensor:
    """`conv7_halo` in plain PyTorch: the rows reflect-padded, the columns
    of the output's `width` read from x from column xoff on, reflected on
    the image's edges (`edges`) and from x's halo elsewhere
    (parallel/halo.py::columns)."""
    xc = columns(x, xoff, width, -PAD, width + PAD, edges)
    return conv7_plain(F.pad(xc, (0, 0, PAD, PAD), mode="reflect"), w, bias)


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """The tensor-core conv body's weight layout: (Co, Ci, K, K) OIHW ->
    (Ci_pad / 8, K * K, Co_pad, 8), entry [g, t, o, e] = w[o, 8g + e,
    t // K, t % K], zero where o >= Co or 8g + e >= Ci; Ci_pad is Ci rounded
    up to 16 (one wgmma K step), Co_pad Co rounded up to 8. The kernel loads
    BN output channels of one 8-channel group for all taps as one box of a
    tensor map over this layout."""
    co, ci, k = w.shape[:3]
    co_pad, ci_pad = -(-co // 8) * 8, -(-ci // 16) * 16
    if (co_pad, ci_pad) != (co, ci):
        w = F.pad(w, (0, 0, 0, 0, 0, ci_pad - ci, 0, co_pad - co))
    # (Ci_pad, K, K, Co_pad) -> (G, 8, K*K, Co_pad) -> (G, K*K, Co_pad, 8)
    return (w.permute(1, 2, 3, 0).reshape(ci_pad // 8, 8, k * k, co_pad)
            .permute(0, 2, 3, 1).contiguous())


def taps_shape(co: int, ci: int, k: int) -> tuple[int, int, int, int]:
    """The shape `pack_taps` gives a (co, ci, k, k) weight."""
    return (-(-ci // 16) * 2, k * k, -(-co // 8) * 8, 8)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of an f32 tensor: big = tf32(x), small = tf32(x -
    big), each an f32 tensor whose low 13 mantissa bits are zero. tf32()
    rounds to the nearest value with 10 explicit mantissa bits, ties away
    from zero, as the kernel's `cvt.rna.tf32.f32` does: on the int32 view,
    add half of the dropped range to the magnitude's bits, then clear them
    (subnormals included; x - big is exact in f32). big + small is x to
    within 2**-21 of |x|."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
        return (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)
    x = x.float()
    big = tf32(x)
    return big, tf32(x - big)


def pack_taps_3xtf32(w: torch.Tensor) -> torch.Tensor:
    """The f32 tensor-core body's weight layout: (Co, Ci, K, K) OIHW ->
    (Ci_pad / 4, 2, K * K, Co_pad, 4) f32, entry [g, p, t, o, e] = part p
    (0: big, 1: small; `split_tf32`) of w[o, 4g + e, t // K, t % K], zero
    where o >= Co or 4g + e >= Ci; Ci_pad is Ci rounded up to 8 (one tf32
    wgmma K step), Co_pad Co rounded up to 8. The kernel loads BN output
    channels of one 4-channel group, both parts, all taps, as one box of a
    tensor map over this layout. Twice the bytes of the f32 weight."""
    co, ci, k = w.shape[:3]
    co_pad, ci_pad = -(-co // 8) * 8, -(-ci // 8) * 8
    if (co_pad, ci_pad) != (co, ci):
        w = F.pad(w, (0, 0, 0, 0, 0, ci_pad - ci, 0, co_pad - co))
    # (Ci_pad, K, K, Co_pad) -> (G, 4, K*K, Co_pad) -> (G, K*K, Co_pad, 4)
    parts = [p.permute(1, 2, 3, 0).reshape(ci_pad // 4, 4, k * k, co_pad).permute(0, 2, 3, 1)
             for p in split_tf32(w)]
    return torch.stack(parts, 1).contiguous()


def taps_shape_3xtf32(co: int, ci: int, k: int) -> tuple[int, int, int, int, int]:
    """The shape `pack_taps_3xtf32` gives a (co, ci, k, k) weight."""
    return (-(-ci // 8) * 2, 2, k * k, -(-co // 8) * 8, 4)


def pack_for_kernel(w: torch.Tensor) -> torch.Tensor:
    """The packed weight the tensor-core body takes for w's dtype: bf16
    `pack_taps`, f32 `pack_taps_3xtf32`."""
    return pack_taps_3xtf32(w) if w.dtype == torch.float32 else pack_taps(w)


def packed_shape_for(dtype: torch.dtype, co: int, ci: int, k: int) -> tuple:
    """The shape of `pack_for_kernel` of a (co, ci, k, k) weight of dtype."""
    return taps_shape_3xtf32(co, ci, k) if dtype == torch.float32 else taps_shape(co, ci, k)


# the conv bodies (csrc/common.cuh::Body)
TENSOR_CORES, CUDA_CORES = 1, 2
_forced_conv7_body: list = []  # the body forced_conv7_body() holds, if any


def conv7_body(dtype: torch.dtype, ci: int, co: int) -> int:
    """The body a 7x7 conv of dtype runs on the card, a fixed rule on its
    shape: the tensor cores (csrc/conv_wgmma.cuh; in f32 as 3xTF32), but
    for an f32 conv with Co <= 8 or Ci <= 4 the CUDA cores
    (csrc/conv_kxk.cuh). There an n8 wgmma holds 3 of 8 output channels
    (the Co = 3 heads) or a k8 step 3 of 8 input channels (the Ci = 3
    Encoder stem), and each of its products still reads its whole A operand
    from shared memory; the CUDA-core tile is sized to Co. The shapes of the
    single-image paths and the same-run A/B of the two bodies at each
    (chip_smoke.py phase 6) are in PERF.md. Every 3x3 conv (respair, conv3,
    conv3_fused) runs on the tensor cores, which won that A/B at every
    respair shape."""
    if dtype != torch.float32:
        return TENSOR_CORES
    if _forced_conv7_body:
        return _forced_conv7_body[-1]
    return CUDA_CORES if co <= 8 or ci <= 4 else TENSOR_CORES


@contextlib.contextmanager
def forced_conv7_body(body: int):
    """Within the block every f32 7x7 conv launch runs `body` (TENSOR_CORES
    or CUDA_CORES), whatever `conv7_body`'s rule says: for an A/B of the two
    bodies at one shape. Nothing in the port selects it."""
    _forced_conv7_body.append(body)
    try:
        yield
    finally:
        _forced_conv7_body.pop()


def check_packed(what: str, x: torch.Tensor, packed: torch.Tensor, co: int, ci: int,
                 k: int) -> None:
    """Raise unless `packed` is the tensor-core body's packed weight of a
    (co, ci, k, k) weight for x's dtype, on x's device, contiguous."""
    if packed.dtype != x.dtype:
        kind = "bf16" if packed.dtype == torch.bfloat16 else f"{packed.dtype} (3xTF32)"
        raise ValueError(f"{what}: packed weights are the {kind} kernel's, x is {x.dtype}")
    want = packed_shape_for(x.dtype, co, ci, k)
    if tuple(packed.shape) != want:
        raise ValueError(f"{what}: packed {tuple(packed.shape)} != {want}")
    build.require_cuda_operands(what, x.device, x.dtype, packed=packed)


def pack_conv7_weight(w: torch.Tensor) -> torch.Tensor:
    """The bf16 7x7 body's weight layout, (Co, Ci, 7, 7) -> (Ci_pad / 8, 49,
    Co_pad, 8): see `pack_taps`."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (K, K):
        raise ValueError(f"pack_conv7_weight: w must be (Co, Ci, 7, 7), got {tuple(w.shape)}")
    return pack_taps(w)


def wants_grad(*tensors) -> bool:
    """Whether autograd records a call on these inputs (grad mode on and
    one of them requiring grad); without it a wrapper skips its
    autograd.Function, whose bookkeeping is host time on every call."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _check(x, w, bias, reflect: bool) -> None:
    """Raise on shapes the op does not take."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (K, K):
        raise ValueError(
            f"conv7: x must be (B, Ci, H, W) and w (Co, Ci, 7, 7), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"conv7: w {tuple(w.shape)} does not take Ci = {x.shape[1]}")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"conv7: bias {tuple(bias.shape)} != {(w.shape[0],)}")
    h, wd = x.shape[2:]
    if reflect:
        if h <= PAD or wd <= PAD:
            raise ValueError(f"conv7: reflect padding needs H, W >= 4, got {h}x{wd}")
    elif h < K or wd < K:
        raise ValueError(f"conv7: a VALID 7x7 conv needs H, W >= 7, got {h}x{wd}")


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _conv7_cuda(x, w, bias, packed, reflect: bool, xoff: int = 0, width: int = 0,
                edges: int = BOTH_EDGES) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel (with a
    width, in the column-halo mode)."""
    code = build.require_cuda_operands("conv7", x.device, x.dtype, x=x, w=w)
    if bias is not None:
        build.require_cuda_operands("conv7", x.device, torch.float32, bias=bias)
    co, ci = w.shape[:2]
    if packed is not None:
        check_packed("conv7", x, packed, co, ci, K)
    body = conv7_body(x.dtype, ci, co)
    if body == TENSOR_CORES and packed is None:
        packed = pack_for_kernel(w)
    elif body != TENSOR_CORES:
        packed = None
    h, wd = (x.shape[2], x.shape[3]) if reflect else (x.shape[2] - 2 * PAD, x.shape[3] - 2 * PAD)
    if width:
        wd = width
    fn = build.function("v2v_conv7", [_VOID] * 5 + [_INT] * 11 + [_VOID])
    out = torch.empty((x.shape[0], co, h, wd), dtype=x.dtype, device=x.device)
    err = build.launch(fn, x.device, x.data_ptr(), w.data_ptr(),
                       None if packed is None else packed.data_ptr(),
                       None if bias is None else bias.data_ptr(), out.data_ptr(),
                       x.shape[0], ci, co, h, wd, int(reflect), xoff, x.shape[3], edges,
                       code, body)
    build.check(err, "conv7 kernel launch")
    (conv7_halo if width else conv7_reflect if reflect else conv7_padded).launches += 1
    return out


def _conv7_plain(x, w, bias, packed, reflect: bool, xoff: int = 0, width: int = 0,
                 edges: int = BOTH_EDGES) -> torch.Tensor:
    if width:
        return conv7_halo_plain(x, w, bias, xoff, width, edges)
    return (conv7_reflect_plain if reflect else conv7_plain)(x, w, bias)


def _conv7_fake(x, w, bias, packed, reflect: bool, xoff: int = 0, width: int = 0,
                edges: int = BOTH_EDGES) -> torch.Tensor:
    pad = 0 if reflect else 2 * PAD
    return x.new_empty((x.shape[0], w.shape[0], x.shape[2] - pad,
                        width or x.shape[3] - pad))


# width > 0: the column-halo mode (`conv7_halo`), reflect only
CONV7_OP = library.define(
    "conv7", "(Tensor x, Tensor w, Tensor? bias, Tensor? packed, bool reflect, "
    f"int xoff=0, int width=0, int edges={BOTH_EDGES}) -> Tensor",
    cpu=_conv7_plain, cuda=_conv7_cuda, fake=_conv7_fake,
)


def plain_vjp(plain, inputs: tuple, needs: tuple, g: torch.Tensor) -> tuple:
    """The gradients of `plain(*inputs)` for the cotangent g by autograd of
    the plain version: one per input, None where `needs` is False."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    if not wanted:
        return (None,) * len(leaves)
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, g))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


class _Conv7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, reflect, packed):
        ctx.save_for_backward(x, w, bias)
        ctx.reflect = reflect
        return CONV7_OP(x, w, bias, packed, reflect)

    @staticmethod
    def backward(ctx, g):
        plain = conv7_reflect_plain if ctx.reflect else conv7_plain
        return (*plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None, None)


def _conv7(x, w, bias, reflect, packed):
    _check(x, w, bias, reflect)
    if wants_grad(x, w, bias):
        return _Conv7.apply(x, w, bias, reflect, packed)
    return CONV7_OP(x, w, bias, packed, reflect)


def conv7_reflect(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """ReflectionPad2d(3) + 7x7 conv: (B, Ci, H, W) -> (B, Co, H, W).

    w: (Co, Ci, 7, 7) in x's dtype; bias: (Co,) float32 or None; packed:
    optionally `pack_for_kernel(w)` (bf16: `pack_conv7_weight(w)`; f32:
    `pack_taps_3xtf32(w)`), made once by the caller. A CPU tensor takes
    `conv7_reflect_plain`; a CUDA tensor launches the kernel (f32 or bf16,
    contiguous, H, W >= 4) or raises.
    """
    return _conv7(x, w, bias, True, packed)


def conv7_padded(
    xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """VALID 7x7 conv of a pre-padded (B, Ci, H+6, W+6) input -> (B, Co, H,
    W): the Pallas kernel's contract, with the same dtypes, packed weights
    and device rule as `conv7_reflect`."""
    return _conv7(xp, w, bias, False, packed)


def conv7_halo(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, xoff: int, width: int,
    edges: int, packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """`conv7_reflect` of a width shard: (B, Ci, H, w_in) -> (B, Co, H,
    width), output column j from x's column j + xoff. x carries at least 3
    neighbour columns on each inner side (parallel/halo.py::attach); the
    sides that `edges` marks as the image's (parallel/halo.py::LEFT_EDGE,
    RIGHT_EDGE) are reflected. With xoff 0, width W and both edges it is
    conv7_reflect of x, bit for bit on the card. Inference only (no
    gradient); a CPU tensor takes `conv7_halo_plain`."""
    _check(x, w, bias, True)
    if wants_grad(x, w, bias):
        raise NotImplementedError("conv7_halo carries no gradient: no train-mode path calls "
                                  "the column-halo mode (train mode pads through halo.padded)")
    need_l = 0 if edges & LEFT_EDGE else PAD
    need_r = 0 if edges & RIGHT_EDGE else PAD
    if width < 1 or xoff < need_l or x.shape[3] < xoff + width + need_r:
        raise ValueError(f"conv7_halo: {x.shape[3]} input columns cannot hold {width} from "
                         f"column {xoff} with the halos of edges {edges}")
    return CONV7_OP(x, w, bias, packed, True, xoff, width, edges)


conv7_reflect.launches = 0
conv7_padded.launches = 0
conv7_halo.launches = 0
