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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops import library
from vid2vid_tpu_torch.ops.conv7 import check_packed, pack_for_kernel, plain_vjp, wants_grad

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


def _check_shapes(x, k0, ab0, k1, ab1) -> None:
    if x.dim() != 4:
        raise ValueError(f"respair: x must be (B, C, H, W), got {tuple(x.shape)}")
    c, h, w = x.shape[1:]
    for name, k in (("k0", k0), ("k1", k1)):
        if tuple(k.shape) != (c, c, 3, 3):
            raise ValueError(f"respair: {name} {tuple(k.shape)} != {(c, c, 3, 3)}")
    for v in (*ab0, *ab1):
        if tuple(v.shape) != (c,):
            raise ValueError(f"respair: affine {tuple(v.shape)} != {(c,)}")
    if h < 2 or w < 2:
        raise ValueError(f"respair: reflect padding needs H, W >= 2, got {h}x{w}")


def _check_packed(x, k0, packed) -> None:
    c = k0.shape[0]
    for name, p in zip(("packed k0", "packed k1"), packed):
        check_packed(f"respair: {name}", x, p, c, c, 3)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _respair_cuda(x, k0, a0, c0, k1, a1, c1, packed0, packed1) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel."""
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
        "v2v_respair", [_VOID] * 9 + [_INT] * 5 + [_VOID]
    )
    hbuf = torch.empty_like(x)
    out = torch.empty_like(x)
    err = build.launch(
        fn, x.device, x.data_ptr(), packed0.data_ptr(), a0.data_ptr(), c0.data_ptr(),
        packed1.data_ptr(), a1.data_ptr(), c1.data_ptr(),
        hbuf.data_ptr(), out.data_ptr(), b, c, h, w, code,
    )
    build.check(err, "respair kernel launch")
    respair.launches += 1
    return out


def _respair_plain_flat(x, k0, a0, c0, k1, a1, c1, packed0=None, packed1=None):
    return respair_plain(x, k0, (a0, c0), k1, (a1, c1))


RESPAIR_OP = library.define(
    "respair",
    "(Tensor x, Tensor k0, Tensor a0, Tensor c0, Tensor k1, Tensor a1, Tensor c1, "
    "Tensor? packed0, Tensor? packed1) -> Tensor",
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


respair.launches = 0
