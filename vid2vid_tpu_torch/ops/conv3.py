"""The 3x3 stride-1 conv of a pre-padded input (the port of ops/conv3_pallas.py).

    conv3_padded(xp, w)        = conv2d(xp, w)                          (VALID)
    conv3_fused_padded(xp, w, scale, offset, residual, relu)
                               = conv2d(xp, w) * scale + offset [+ residual] [ReLU]

NCHW inputs, OIHW weights; xp is (B, Ci, H+2, W+2), padded by the caller
(reflect or zero). On a CUDA tensor both launch the K = 3 entries of the
hand-written conv kernel (csrc/conv.cu: `v2v_conv3`, no epilogue, and
`v2v_conv3_fused`, the epilogue on the f32 accumulator; f32 or bf16, any
Ci, Co, H, W) or raise; on a CPU tensor they run their plain versions, which
are also the kernel's oracles. The Pallas kernels' Ci % 128, Co % 128 and
block-divisibility rules do not carry over.

Neither has a caller in the JAX package (its residual blocks run the whole
block as one op, ops/respair_pallas.py), so none is added here: the tests
and chip_smoke.py drive them. `conv3_padded`'s gradient is the plain
version's autograd, as the JAX backward is the XLA conv's VJP;
`conv3_fused_padded` has no gradient, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops.conv7 import plain_vjp


def conv3_plain(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 conv in plain PyTorch, in xp's dtype."""
    return F.conv2d(xp, w.to(xp.dtype))


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _conv3_forward(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    h, wd = _check(xp, w)
    if xp.device.type == "cpu":
        return conv3_plain(xp, w)
    code = build.require_cuda_operands("conv3", xp.device, xp.dtype, xp=xp, w=w)
    fn = build.function("v2v_conv3", [_VOID] * 3 + [_INT] * 6 + [_VOID])
    b, ci = xp.shape[:2]
    out = torch.empty((b, w.shape[0], h, wd), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):  # launch on the operands' card
        err = fn(xp.data_ptr(), w.data_ptr(), out.data_ptr(), b, ci, w.shape[0],
                 h, wd, code, _stream(xp))
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
    return _Conv3.apply(xp, w)


def conv3_fused_padded(
    xp: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
    residual: torch.Tensor | None = None, relu: bool = False,
) -> torch.Tensor:
    """conv3_padded, then `* scale + offset [+ residual] [ReLU]` on the f32
    accumulator: the eval-mode conv + norm (+ skip) step.

    scale, offset: (Co,) float32; residual: (B, Co, H, W) in xp's dtype or
    None. Same device rule as `conv3_padded`; no gradient.
    """
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
    with torch.cuda.device(xp.device):
        err = fn(xp.data_ptr(), w.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                 None if residual is None else residual.data_ptr(), out.data_ptr(),
                 b, xp.shape[1], co, h, wd, int(relu), code, _stream(xp))
    build.check(err, "conv3_fused kernel launch")
    conv3_fused_padded.launches += 1
    return out


conv3_padded.launches = 0
conv3_fused_padded.launches = 0
