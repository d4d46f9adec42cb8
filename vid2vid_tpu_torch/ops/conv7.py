"""The 7x7 stride-1 conv as one op (the port of ops/conv7_pallas.py).

    conv7_padded(xp, w, bias)  = conv2d(xp, w) + bias        (VALID)
    conv7_reflect(x, w, bias)  = conv2d(reflect_pad(x, 3), w) + bias

NCHW inputs and OIHW weights, as nn.Conv2d holds them; the bias is
optional. On a CUDA tensor both launch the hand-written kernel
(csrc/conv.cu::v2v_conv7: f32 or bf16, f32 accumulation, the reflect pad
folded into the load addressing, any shape) or raise; on a CPU tensor they
run `conv7_plain`, which is also the kernel's oracle. In bf16 the kernel
runs on the tensor cores (csrc/conv_wgmma.cuh with K = 7) and takes the
weights in the layout of `pack_conv7_weight`: a caller that runs the conv
often packs them once and passes them as `packed` (nn/layers.py::
ReflectConv7); otherwise they are packed on each call. Unlike the TPU
entry point no shape rule here picks between kernel and conv: the Pallas
dispatch (`on_tpu`, h*w >= 256**2, `_pick_blocks`) is a Mosaic tiling
constraint. The gradient is the plain version's autograd, as the JAX
backward is the XLA conv's VJP.

`plain_vjp`, `wants_grad` and `pack_taps` serve the other kernel wrappers
too.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build

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


def _check(x, w, bias, reflect: bool) -> tuple[int, int]:
    """The output (H, W); raises on shapes the op does not take."""
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
        return h, wd
    if h < K or wd < K:
        raise ValueError(f"conv7: a VALID 7x7 conv needs H, W >= 7, got {h}x{wd}")
    return h - K + 1, wd - K + 1


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _forward(x, w, bias, reflect: bool, packed) -> torch.Tensor:
    h, wd = _check(x, w, bias, reflect)
    if x.device.type == "cpu":
        return (conv7_reflect_plain if reflect else conv7_plain)(x, w, bias)
    code = build.require_cuda_operands("conv7", x.device, x.dtype, x=x, w=w)
    if bias is not None:
        build.require_cuda_operands("conv7", x.device, torch.float32, bias=bias)
    if packed is not None:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"conv7: packed weights are the bf16 kernel's, x is {x.dtype}")
        want = taps_shape(*w.shape[:2], K)
        if tuple(packed.shape) != want:
            raise ValueError(f"conv7: packed {tuple(packed.shape)} != {want}")
        build.require_cuda_operands("conv7", x.device, x.dtype, packed=packed)
    elif x.dtype == torch.bfloat16:
        packed = pack_taps(w)
    fn = build.function("v2v_conv7", [_VOID] * 5 + [_INT] * 7 + [_VOID])
    out = torch.empty((x.shape[0], w.shape[0], h, wd), dtype=x.dtype, device=x.device)
    err = build.launch(fn, x.device, x.data_ptr(), w.data_ptr(),
                       None if packed is None else packed.data_ptr(),
                       None if bias is None else bias.data_ptr(), out.data_ptr(),
                       x.shape[0], x.shape[1], w.shape[0], h, wd, int(reflect), code)
    build.check(err, "conv7 kernel launch")
    (conv7_reflect if reflect else conv7_padded).launches += 1
    return out


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
        return _forward(x, w, bias, reflect, packed)

    @staticmethod
    def backward(ctx, g):
        plain = conv7_reflect_plain if ctx.reflect else conv7_plain
        return (*plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:3], g), None, None)


def _conv7(x, w, bias, reflect, packed):
    if wants_grad(x, w, bias):
        return _Conv7.apply(x, w, bias, reflect, packed)
    return _forward(x, w, bias, reflect, packed)


def conv7_reflect(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """ReflectionPad2d(3) + 7x7 conv: (B, Ci, H, W) -> (B, Co, H, W).

    w: (Co, Ci, 7, 7) in x's dtype; bias: (Co,) float32 or None; packed: in
    bf16 optionally `pack_conv7_weight(w)`, made once by the caller. A CPU
    tensor takes `conv7_reflect_plain`; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, H, W >= 4) or raises.
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


conv7_reflect.launches = 0
conv7_padded.launches = 0
