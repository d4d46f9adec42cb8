"""The eval-mode residual block as one op (the port of ops/respair_pallas.py).

    h   = relu(conv3x3(reflect_pad(x, 1)) * a0 + c0)
    out = x + conv3x3(reflect_pad(h, 1)) * a1 + c1

(a, c) fold the conv bias and the eval-mode norm into one per-channel
affine (nn/layers.py::eval_affine). `respair` runs the hand-written CUDA
kernel (csrc/respair.cu) on a CUDA tensor and `respair_plain` on a CPU
tensor (the operator `torch.ops.v2v.respair`, ops/library.py, dispatches
on the device); `respair_plain` is also the kernel's oracle. Unlike the TPU kernel
it takes any channel count and any H, W >= 2. The kernel runs on the
tensor cores (bf16; f32 as 3xTF32) and takes its weights packed
(ops/conv7.py::pack_for_kernel: pack_conv3_weight in bf16,
pack_taps_3xtf32 in f32): a caller that runs the block often packs them
once and passes them as `packed` (nn/blocks.py::ResnetBlock); otherwise
they are packed on each call. The gradient is the plain version's autograd (on the
unpacked weights), as the JAX package differentiates its plain block.

`respair_halo` is the block of a width shard (the model axis,
parallel/halo.py), the kernel's column-halo mode: x with two neighbour
columns on each inner side, h computed wider there, reflected only at the
image's edges; `respair_halo_plain` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops import library
from vid2vid_tpu_torch.ops.conv7 import check_packed, pack_for_kernel, plain_vjp, wants_grad
from vid2vid_tpu_torch.parallel.halo import ALIGN, BOTH_EDGES, LEFT_EDGE, RIGHT_EDGE, columns

Affine = tuple[torch.Tensor, torch.Tensor]


def _conv3_reflect(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k)


def respair_plain(
    x: torch.Tensor, k0: torch.Tensor, ab0: Affine, k1: torch.Tensor, ab1: Affine
) -> torch.Tensor:
    """The residual block in plain PyTorch, computed in x's dtype."""
    dt = x.dtype
    a0, c0 = (v.to(dt).view(1, -1, 1, 1) for v in ab0)
    a1, c1 = (v.to(dt).view(1, -1, 1, 1) for v in ab1)
    h = torch.relu(_conv3_reflect(x, k0.to(dt)) * a0 + c0)
    return _conv3_reflect(h, k1.to(dt)) * a1 + c1 + x


def respair_halo_plain(
    x: torch.Tensor, x_in: torch.Tensor, xoff: int, edges: int, k0: torch.Tensor,
    ab0: Affine, k1: torch.Tensor, ab1: Affine,
) -> torch.Tensor:
    """`respair_halo` in plain PyTorch, in x's dtype: h on x's columns and
    one more on each inner side (parallel/halo.py::columns of x_in), then
    the second conv on h's columns, reflected on the image's edges."""
    dt, w = x.dtype, x.shape[3]
    a0, c0 = (v.to(dt).view(1, -1, 1, 1) for v in ab0)
    a1, c1 = (v.to(dt).view(1, -1, 1, 1) for v in ab1)
    hl = 0 if edges & LEFT_EDGE else 1
    hr = 0 if edges & RIGHT_EDGE else 1

    def conv(t, xo, lo, hi, k):
        tc = columns(t, xo, w, lo, hi, edges)
        return F.conv2d(F.pad(tc, (0, 0, 1, 1), mode="reflect"), k.to(dt))

    h = torch.relu(conv(x_in, xoff, -hl - 1, w + hr + 1, k0) * a0 + c0)
    return conv(h, hl, -1, w + 1, k1) * a1 + c1 + x


def _check_shapes(x, k0, ab0, k1, ab1, least_w: int = 2) -> None:
    if x.dim() != 4:
        raise ValueError(f"respair: x must be (B, C, H, W), got {tuple(x.shape)}")
    c, h, w = x.shape[1:]
    for name, k in (("k0", k0), ("k1", k1)):
        if tuple(k.shape) != (c, c, 3, 3):
            raise ValueError(f"respair: {name} {tuple(k.shape)} != {(c, c, 3, 3)}")
    for v in (*ab0, *ab1):
        if tuple(v.shape) != (c,):
            raise ValueError(f"respair: affine {tuple(v.shape)} != {(c,)}")
    if h < 2 or w < least_w:
        raise ValueError(f"respair: reflect padding needs H, W >= 2 (W >= 1 on a width "
                         f"shard), got {h}x{w}")


def _check_packed(x, k0, packed) -> None:
    c = k0.shape[0]
    for name, p in zip(("packed k0", "packed k1"), packed):
        check_packed(f"respair: {name}", x, p, c, c, 3)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _respair_cuda(x, k0, a0, c0, k1, a1, c1, packed0, packed1, x_in=None, xoff=0,
                  edges=BOTH_EDGES) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel (with
    x_in, in the column-halo mode)."""
    code = build.require_cuda_operands(
        "respair", x.device, x.dtype, x=x, k0=k0, k1=k1
    )
    build.require_cuda_operands(
        "respair", x.device, torch.float32, a0=a0, c0=c0, a1=a1, c1=c1
    )
    if packed0 is not None:
        _check_packed(x, k0, (packed0, packed1))
    else:
        packed0, packed1 = pack_for_kernel(k0), pack_for_kernel(k1)
    b, c, h, w = x.shape
    fn = build.function(
        "v2v_respair",
        [_VOID, _VOID, _INT, _INT, _INT] + [_VOID] * 7 + [_INT, _VOID] + [_INT] * 5 + [_VOID],
    )
    if x_in is None:
        x_in, ldh = x, w
    else:  # h wider on the inner sides (csrc/respair.cu: 8 left, 1 right), rows aligned
        build.require_cuda_operands("respair", x.device, x.dtype, x_in=x_in)
        wh = w + (0 if edges & LEFT_EDGE else ALIGN) + (0 if edges & RIGHT_EDGE else 1)
        ldh = -(-wh // ALIGN) * ALIGN
    hbuf = x.new_empty((b, c, h, ldh))
    out = torch.empty_like(x)
    err = build.launch(
        fn, x.device, x.data_ptr(), x_in.data_ptr(), xoff, x_in.shape[3], edges,
        packed0.data_ptr(), a0.data_ptr(), c0.data_ptr(),
        packed1.data_ptr(), a1.data_ptr(), c1.data_ptr(),
        hbuf.data_ptr(), ldh, out.data_ptr(), b, c, h, w, code,
    )
    build.check(err, "respair kernel launch")
    (respair if x_in is x else respair_halo).launches += 1
    return out


def _respair_plain_flat(x, k0, a0, c0, k1, a1, c1, packed0=None, packed1=None, x_in=None,
                        xoff=0, edges=BOTH_EDGES):
    if x_in is not None:
        return respair_halo_plain(x, x_in, xoff, edges, k0, (a0, c0), k1, (a1, c1))
    return respair_plain(x, k0, (a0, c0), k1, (a1, c1))


# x_in given: the column-halo mode (`respair_halo`)
RESPAIR_OP = library.define(
    "respair",
    "(Tensor x, Tensor k0, Tensor a0, Tensor c0, Tensor k1, Tensor a1, Tensor c1, "
    f"Tensor? packed0, Tensor? packed1, Tensor? x_in=None, int xoff=0, int edges={BOTH_EDGES}"
    ") -> Tensor",
    cpu=_respair_plain_flat, cuda=_respair_cuda,
    fake=lambda x, *args: torch.empty_like(x),
)


class _Respair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k0, a0, c0, k1, a1, c1, packed0, packed1):
        ctx.save_for_backward(x, k0, a0, c0, k1, a1, c1)
        return RESPAIR_OP(x, k0, a0, c0, k1, a1, c1, packed0, packed1)

    @staticmethod
    def backward(ctx, g):
        return (*plain_vjp(_respair_plain_flat, ctx.saved_tensors, ctx.needs_input_grad[:7],
                           g), None, None)


def respair(
    x: torch.Tensor, k0: torch.Tensor, ab0: Affine, k1: torch.Tensor, ab1: Affine,
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One eval-mode residual block.

    x: (B, C, H, W); k0, k1: (C, C, 3, 3) OIHW in x's dtype; ab0, ab1:
    (scale, offset) pairs of (C,) float32; packed: optionally
    (pack_for_kernel(k0), pack_for_kernel(k1)) (ops/conv7.py), made once by
    the caller.
    Returns (B, C, H, W) in x's dtype. A CPU tensor takes `respair_plain`; a
    CUDA tensor launches the kernel (f32 or bf16, contiguous) or raises.
    The gradient, for every tensor but `packed`, is `respair_plain`'s.
    """
    _check_shapes(x, k0, ab0, k1, ab1)
    (a0, c0), (a1, c1) = ab0, ab1
    packed0, packed1 = packed or (None, None)
    if wants_grad(x, k0, a0, c0, k1, a1, c1):
        return _Respair.apply(x, k0, a0, c0, k1, a1, c1, packed0, packed1)
    return RESPAIR_OP(x, k0, a0, c0, k1, a1, c1, packed0, packed1)


def respair_halo(
    x: torch.Tensor, x_in: torch.Tensor, xoff: int, edges: int, k0: torch.Tensor,
    ab0: Affine, k1: torch.Tensor, ab1: Affine,
    packed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One eval residual block of a width shard: x (B, C, H, W) its columns,
    x_in (B, C, H, w_in) the same with at least two neighbour columns on
    each inner side, x's column j at x_in's column j + xoff
    (parallel/halo.py::attach); `edges` the sides that are the image's
    (parallel/halo.py::LEFT_EDGE, RIGHT_EDGE), reflected there. One
    exchange serves both convs: h is computed one column beyond x on each
    inner side. With x_in = x, xoff 0 and both edges it is `respair`, bit
    for bit on the card. x may be one column wide: on a side that is the
    image's edge both convs reflect into the halo of the other side.
    Inference only (no gradient); a CPU tensor takes
    `respair_halo_plain`."""
    _check_shapes(x, k0, ab0, k1, ab1, least_w=1)
    (a0, c0), (a1, c1) = ab0, ab1
    if wants_grad(x, x_in, k0, a0, c0, k1, a1, c1):
        raise NotImplementedError("respair_halo carries no gradient: no train-mode path "
                                  "calls the column-halo mode (train mode runs the plain block)")
    need_l = 0 if edges & LEFT_EDGE else 2
    need_r = 0 if edges & RIGHT_EDGE else 2
    if (x_in.shape[:3] != x.shape[:3] or xoff < need_l
            or x_in.shape[3] < xoff + x.shape[3] + need_r):
        raise ValueError(f"respair_halo: x_in {tuple(x_in.shape)} cannot hold x "
                         f"{tuple(x.shape)} from column {xoff} with the halos of edges {edges}")
    packed0, packed1 = packed or (None, None)
    return RESPAIR_OP(x, k0, a0, c0, k1, a1, c1, packed0, packed1, x_in, xoff, edges)


respair.launches = 0
respair_halo.launches = 0
