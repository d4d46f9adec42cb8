"""The 3x3 stride-1 conv of a pre-padded input (the port of ops/conv3_pallas.py).

    conv3_padded(xp, w)        = conv2d(xp, w)                          (VALID)
    conv3_fused_padded(xp, w, scale, offset, residual, relu)
                               = conv2d(xp, w) * scale + offset [+ residual] [ReLU]

NCHW inputs, OIHW weights; xp is (B, Ci, H+2, W+2), padded by the caller
(reflect or zero). On a CUDA tensor both launch the 3x3 entries of the
hand-written conv kernels (csrc/conv.cu: `v2v_conv3`, no epilogue, and
`v2v_conv3_fused`, the epilogue on the f32 accumulator; any Ci, Co, H, W)
or raise: on the tensor-core body (csrc/conv_wgmma.cuh; bf16, and f32 as
3xTF32), which takes the weights packed (ops/conv7.py::pack_for_kernel:
`pack_conv3_weight` in bf16, ops/conv7.py::pack_taps_3xtf32 in f32) here
on each call. On a CPU tensor they run their plain versions, which are
also the kernels' oracles.
The Pallas kernels' Ci % 128, Co % 128 and block-divisibility rules do not
carry over.

Neither has a caller in the JAX package (its residual blocks run the whole
block as one op, ops/respair_pallas.py), so none is added here: the tests
and chip_smoke.py drive them. Their gradient is the plain version's
autograd, as the JAX backward is the XLA conv's VJP.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops.conv7 import (
    pack_for_kernel,
    pack_taps,
    plain_vjp,
    taps_shape,
    wants_grad,
)


def conv3_plain(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv in plain PyTorch, in xp's dtype."""
    return F.conv2d(xp, w.to(xp.dtype))


def pack_conv3_weight(w: torch.Tensor) -> torch.Tensor:
    """The bf16 3x3 body's weight layout: (Co, Ci, 3, 3) OIHW ->
    (Ci_pad / 8, 9, Co_pad, 8), entry [g, t, o, e] = w[o, 8g + e, t // 3,
    t % 3], zero where o >= Co or 8g + e >= Ci (ops/conv7.py::pack_taps).
    The kernel loads BN output channels of one 8-channel group for all taps
    as one box of a tensor map over this layout, two groups per stage."""
    return pack_taps(w)


def packed_shape(co: int, ci: int) -> tuple[int, int, int, int]:
    """The shape `pack_conv3_weight` gives an (co, ci, 3, 3) weight."""
    return taps_shape(co, ci, 3)


def conv3_fused_plain(
    xp: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
    residual: torch.Tensor | None = None, relu: bool = False,
) -> torch.Tensor:
    """conv3_plain, then the epilogue, in xp's dtype."""
    dt = xp.dtype
    out = conv3_plain(xp, w) * scale.to(dt).view(1, -1, 1, 1) + offset.to(dt).view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.to(dt)
    return torch.relu(out) if relu else out


def _check(xp, w) -> tuple[int, int]:
    """The output (H, W); raises on shapes the op does not take."""
    if xp.dim() != 4 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(
            f"conv3: xp must be (B, Ci, H+2, W+2) and w (Co, Ci, 3, 3), got "
            f"{tuple(xp.shape)} and {tuple(w.shape)}")
    if w.shape[1] != xp.shape[1]:
        raise ValueError(f"conv3: w {tuple(w.shape)} does not take Ci = {xp.shape[1]}")
    h, wd = xp.shape[2] - 2, xp.shape[3] - 2
    if h < 1 or wd < 1:
        raise ValueError(f"conv3: a pre-padded input needs H, W >= 3, got {tuple(xp.shape)}")
    return h, wd


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _conv3_forward(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    h, wd = _check(xp, w)
    if xp.device.type == "cpu":
        return conv3_plain(xp, w)
    code = build.require_cuda_operands("conv3", xp.device, xp.dtype, xp=xp, w=w)
    fn = build.function("v2v_conv3", [_VOID] * 3 + [_INT] * 6 + [_VOID])
    b, ci = xp.shape[:2]
    out = torch.empty((b, w.shape[0], h, wd), dtype=xp.dtype, device=xp.device)
    wk = pack_for_kernel(w)
    err = build.launch(fn, xp.device, xp.data_ptr(), wk.data_ptr(), out.data_ptr(), b, ci,
                       w.shape[0], h, wd, code)
    build.check(err, "conv3 kernel launch")
    conv3_padded.launches += 1
    return out


class _Conv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w):
        ctx.save_for_backward(xp, w)
        return _conv3_forward(xp, w)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(conv3_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


def conv3_padded(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv: (B, Ci, H+2, W+2) -> (B, Co, H, W).

    w: (Co, Ci, 3, 3) in xp's dtype. A CPU tensor takes `conv3_plain`; a
    CUDA tensor launches the kernel (f32 or bf16, contiguous) or raises.
    """
    if wants_grad(xp, w):
        return _Conv3.apply(xp, w)
    return _conv3_forward(xp, w)


def _conv3_fused_forward(xp, w, scale, offset, residual, relu) -> torch.Tensor:
    h, wd = _check(xp, w)
    co = w.shape[0]
    for name, v in (("scale", scale), ("offset", offset)):
        if tuple(v.shape) != (co,):
            raise ValueError(f"conv3_fused: {name} {tuple(v.shape)} != {(co,)}")
    b = xp.shape[0]
    if residual is not None and tuple(residual.shape) != (b, co, h, wd):
        raise ValueError(f"conv3_fused: residual {tuple(residual.shape)} != {(b, co, h, wd)}")
    if xp.device.type == "cpu":
        return conv3_fused_plain(xp, w, scale, offset, residual, relu)
    extra = {} if residual is None else {"residual": residual}
    code = build.require_cuda_operands("conv3_fused", xp.device, xp.dtype, xp=xp, w=w, **extra)
    build.require_cuda_operands("conv3_fused", xp.device, torch.float32,
                                scale=scale, offset=offset)
    fn = build.function("v2v_conv3_fused", [_VOID] * 6 + [_INT] * 7 + [_VOID])
    out = torch.empty((b, co, h, wd), dtype=xp.dtype, device=xp.device)
    wk = pack_for_kernel(w)
    err = build.launch(fn, xp.device, xp.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                       offset.data_ptr(), None if residual is None else residual.data_ptr(),
                       out.data_ptr(), b, xp.shape[1], co, h, wd, int(relu), code)
    build.check(err, "conv3_fused kernel launch")
    conv3_fused_padded.launches += 1
    return out


class _Conv3Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w, scale, offset, residual, relu):
        ctx.save_for_backward(xp, w, scale, offset, residual)
        ctx.relu = relu
        return _conv3_fused_forward(xp, w, scale, offset, residual, relu)

    @staticmethod
    def backward(ctx, g):
        def plain(xp, w, scale, offset, residual):
            return conv3_fused_plain(xp, w, scale, offset, residual, ctx.relu)
        return (*plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:5], g), None)


def conv3_fused_padded(
    xp: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
    residual: torch.Tensor | None = None, relu: bool = False,
) -> torch.Tensor:
    """conv3_padded, then `* scale + offset [+ residual] [ReLU]` on the f32
    accumulator: the eval-mode conv + norm (+ skip) step.

    scale, offset: (Co,) float32; residual: (B, Co, H, W) in xp's dtype or
    None. Same device rule as `conv3_padded`; the gradient is the plain
    version's autograd.
    """
    if wants_grad(xp, w, scale, offset, residual):
        return _Conv3Fused.apply(xp, w, scale, offset, residual, relu)
    return _conv3_fused_forward(xp, w, scale, offset, residual, relu)


conv3_padded.launches = 0
conv3_fused_padded.launches = 0
