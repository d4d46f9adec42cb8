"""Bilinear flow warping and the warp + temporal blend (NCHW), with gradients.

`flow_warp(image, flow)` samples `image` at pixel coordinates (x + u, y + v),
bilinearly, with the coordinates clamped to the border: the semantics of
vid2vid_tpu/ops/warp.py::flow_warp_ref, computed with the same f32 floor /
clamp arithmetic. On a CUDA tensor it launches the hand-written kernel in
csrc/warp_blend.cu (the unfused entry `v2v_flow_warp`), on a CPU tensor
`flow_warp_plain`; FlowNet2 and its confidence, and the loss engine's warp
losses, call it unfused. It equals the reference's
`F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
align_corners=True)` over a normalized [-1, 1] meshgrid plus the
normalized flow, up to the rounding of the normalization round trip
(tests/test_torch_ops.py holds the two together).

`warp_blend(raw, prev, flow, weight)` is the composite generator's blend
`raw * w + flow_warp(prev, flow) * (1 - w)` (vid2vid_tpu/nn/composite.py::
_blend), through the operator `torch.ops.v2v.warp_blend` (ops/library.py),
which dispatches on the device: the hand-written CUDA kernel
csrc/warp_blend.cu on a CUDA tensor, `warp_blend_plain` on a CPU tensor.

Both are `torch.autograd.Function`s whose backward mirrors the JAX
package's hand-written one (vid2vid_tpu/ops/warp.py::_flow_warp_bwd), which
is the patch formulation: the floor clipped to [0, size-2] and the
fractional weights clipped to [0, 1].
  - d/dimage is the bilinear splat of the cotangent with those weights.
  - d/dflow is the derivative of the patch formulation, with JAX's rule at
    the clip bounds: where a fractional weight sits exactly at 0 or 1 (every
    integer sample coordinate, so every zero flow) the clip passes half the
    gradient, and none beyond. `flow_warp_ref`'s autodiff gives the full
    gradient there instead; the port follows the JAX package's flow_warp.
The backward is the kernel `v2v_flow_warp_bwd` / `v2v_warp_blend_bwd` on a
CUDA tensor (one ctypes call: the entry zeroes its f32 splat and, in bf16,
rounds it into d/dimage itself) and `flow_warp_backward_plain` /
`warp_blend_backward_plain` on a CPU tensor. It needs H and W of at least 2.
"""

from __future__ import annotations

import ctypes

import torch

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops import library
from vid2vid_tpu_torch.ops.conv7 import wants_grad


def _check_flow(image: torch.Tensor, flow: torch.Tensor) -> None:
    s = image.shape
    if len(s) != 4 or flow.shape != (s[0], 2, s[2], s[3]):
        raise ValueError(
            f"flow_warp: image {tuple(image.shape)} and flow "
            f"{tuple(flow.shape)} must share (B, H, W) and flow must have "
            "2 channels"
        )


def _check_blend(raw, prev, flow, weight) -> None:
    _check_flow(prev, flow)
    s = prev.shape
    if raw.shape != s or weight.shape != (s[0], 1, s[2], s[3]):
        raise ValueError(
            f"warp_blend: raw {tuple(raw.shape)}, prev {tuple(prev.shape)} "
            f"and weight {tuple(weight.shape)} disagree"
        )


def _check_backward(image: torch.Tensor) -> None:
    if image.shape[2] < 2 or image.shape[3] < 2:
        raise ValueError(
            f"flow_warp backward: H and W must be at least 2, got "
            f"{tuple(image.shape[2:])} (the patch formulation's floor is "
            "clipped to [0, size-2])"
        )


def _work_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """f32 for the coordinate and weight math, f64 for f64 operands (the
    plain versions' gradient checks)."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def flow_warp_plain(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy), in
    plain PyTorch (gathers)."""
    _check_flow(image, flow)
    b, c, h, w = image.shape
    ct = _work_dtype(flow)
    flow = flow.to(ct)
    ys = torch.arange(h, dtype=ct, device=image.device).view(1, h, 1)
    xs = torch.arange(w, dtype=ct, device=image.device).view(1, 1, w)
    x = xs + flow[:, 0]
    y = ys + flow[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).unsqueeze(1).to(image.dtype)
    wy = (y - y0).unsqueeze(1).to(image.dtype)
    # clamp before the int conversion: indices clamp to the same texels
    x0i = x0.clamp(-1, w).long()
    y0i = y0.clamp(-1, h).long()
    x0c, x1c = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
    y0c, y1c = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)

    flat = image.reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).view(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).view(b, c, h, w)

    top = tap(y0c, x0c) * (1.0 - wx) + tap(y0c, x1c) * wx
    bot = tap(y1c, x0c) * (1.0 - wx) + tap(y1c, x1c) * wx
    return top * (1.0 - wy) + bot * wy


def warp_blend_plain(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """raw * w + flow_warp(prev, flow) * (1 - w) in plain PyTorch."""
    return raw * weight + flow_warp_plain(prev, flow) * (1.0 - weight)


def _clip_grad(u: torch.Tensor) -> torch.Tensor:
    """d clip(u, 0, 1) / du as JAX gives it: 1 inside, 1/2 at a bound, 0
    beyond."""
    inside = ((u > 0) & (u < 1)).to(u.dtype)
    tie = ((u == 0) | (u == 1)).to(u.dtype)
    return inside + 0.5 * tie


def _patch_backward(image, flow, g):
    """The patch formulation's backward in the work dtype (f32, or f64 for
    f64 operands): returns (d/dimage (B, C, H, W), d/dflow (B, 2, H, W), the
    warped image (B, C, H, W)). `g` is the cotangent of the warp's output."""
    b, c, h, w = image.shape
    dev = image.device
    ct = _work_dtype(image, flow, g)
    flow, img, gf = flow.to(ct), image.to(ct), g.to(ct)
    sy = torch.arange(h, dtype=ct, device=dev).view(1, h, 1) + flow[:, 1]
    sx = torch.arange(w, dtype=ct, device=dev).view(1, 1, w) + flow[:, 0]
    y0 = torch.floor(sy).clamp(0, h - 2)
    x0 = torch.floor(sx).clamp(0, w - 2)
    uy, ux = sy - y0, sx - x0  # the fractional weights before their clip
    wy, wx = uy.clamp(0, 1).unsqueeze(1), ux.clamp(0, 1).unsqueeze(1)
    base = (y0.long() * w + x0.long()).view(b, 1, h * w)
    flat = img.reshape(b, c, h * w)
    offsets = (0, 1, w, w + 1)
    v00, v01, v10, v11 = (
        flat.gather(2, (base + o).expand(b, c, h * w)).view(b, c, h, w)
        for o in offsets
    )
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    warped = top * (1 - wy) + bot * wy

    dwx = (gf * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)).sum(1)
    dwy = (gf * (bot - top)).sum(1)
    dflow = torch.stack([dwx * _clip_grad(ux), dwy * _clip_grad(uy)], 1)

    # the splat: every output pixel adds g * tap weight to its four taps
    taps_w = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    rows = (torch.arange(b, device=dev) * (h * w)).view(b, 1)
    acc = torch.zeros(b * h * w, c, dtype=ct, device=dev)
    for o, tw in zip(offsets, taps_w):
        idx = (rows + base.view(b, h * w) + o).reshape(-1)
        acc.index_add_(0, idx, (gf * tw).permute(0, 2, 3, 1).reshape(-1, c))
    dimage = acc.view(b, h, w, c).permute(0, 3, 1, 2)
    return dimage, dflow, warped


def flow_warp_backward_plain(
    image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, d/dflow) of flow_warp at (image, flow) for the output
    cotangent g, in plain PyTorch; each in its input's dtype."""
    _check_flow(image, flow)
    _check_backward(image)
    dimage, dflow, _ = _patch_backward(image, flow, g)
    return dimage.to(image.dtype), dflow.to(flow.dtype)


def warp_blend_backward_plain(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor,
    weight: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """(d_raw, d_prev, d_flow, d_weight) of warp_blend for the cotangent g,
    in plain PyTorch: d_raw = g * w, d_w = sum_c g * (raw - warped), and the
    warp's backward of g * (1 - w) for prev and flow."""
    _check_blend(raw, prev, flow, weight)
    _check_backward(prev)
    ct = _work_dtype(raw, prev, flow, weight, g)
    gf, wf = g.to(ct), weight.to(ct)
    dprev, dflow, warped = _patch_backward(prev, flow, gf * (1 - wf))
    draw = gf * wf
    dweight = (gf * (raw.to(ct) - warped)).sum(1, keepdim=True)
    return (draw.to(raw.dtype), dprev.to(prev.dtype), dflow.to(flow.dtype),
            dweight.to(weight.dtype))


# ------------------------------------------------------------------ kernels

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _flow_warp_forward(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    if image.device.type == "cpu":
        return flow_warp_plain(image, flow)
    code = build.require_cuda_operands(
        "flow_warp", image.device, image.dtype, image=image, flow=flow
    )
    fn = build.function("v2v_flow_warp", [_VOID] * 3 + [_INT] * 5 + [_VOID])
    b, c, h, w = image.shape
    out = torch.empty_like(image)
    err = build.launch(fn, image.device, image.data_ptr(), flow.data_ptr(), out.data_ptr(),
                       b, c, h, w, code)
    build.check(err, "flow_warp kernel launch")
    flow_warp.launches += 1
    return out


def _splat_buffers(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, the f32 buffer the kernel's splat accumulates into), both
    uninitialised: the C entry zeroes the buffer and, in bf16, rounds it
    into d/dimage; in f32 the two are one tensor."""
    dimage = torch.empty_like(image)
    if image.dtype == torch.float32:
        return dimage, dimage
    return dimage, torch.empty(image.shape, dtype=torch.float32, device=image.device)


def flow_warp_bwd(
    image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, d/dflow) of flow_warp for the cotangent g: the kernel
    `v2v_flow_warp_bwd` on a CUDA tensor (all three in one dtype, f32 or
    bf16, contiguous), `flow_warp_backward_plain` on a CPU tensor."""
    _check_flow(image, flow)
    _check_backward(image)
    if image.device.type == "cpu":
        return flow_warp_backward_plain(image, flow, g)
    code = build.require_cuda_operands(
        "flow_warp_bwd", image.device, image.dtype, image=image, flow=flow, g=g
    )
    fn = build.function("v2v_flow_warp_bwd", [_VOID] * 6 + [_INT] * 5 + [_VOID])
    b, c, h, w = image.shape
    dimage, splat = _splat_buffers(image)
    dflow = torch.empty_like(flow)
    err = build.launch(fn, image.device, image.data_ptr(), flow.data_ptr(), g.data_ptr(),
                       dimage.data_ptr(), splat.data_ptr(), dflow.data_ptr(), b, c, h, w,
                       code)
    build.check(err, "flow_warp backward kernel launch")
    flow_warp_bwd.launches += 1
    flow_warp_bwd.second_kernels += image.dtype == torch.bfloat16 and image.numel() > 0  # the splat's cast
    return dimage, dflow


flow_warp_bwd.launches = 0
flow_warp_bwd.second_kernels = 0  # the casts of the f32 splat to bf16


class _FlowWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, flow):
        ctx.save_for_backward(image, flow)
        return _flow_warp_forward(image, flow)

    @staticmethod
    def backward(ctx, g):
        image, flow = ctx.saved_tensors
        return flow_warp_bwd(image, flow, g.contiguous())


def flow_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy).

    A CPU tensor takes `flow_warp_plain`; a CUDA tensor launches the kernel
    (image and flow in one dtype, f32 or bf16, contiguous) or raises. The
    gradient is `flow_warp_bwd`.
    """
    _check_flow(image, flow)
    if wants_grad(image, flow):
        return _FlowWarp.apply(image, flow)
    return _flow_warp_forward(image, flow)


flow_warp.launches = 0


def _warp_blend_cuda(raw, prev, flow, weight) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel."""
    code = build.require_cuda_operands(
        "warp_blend", prev.device, prev.dtype,
        raw=raw, prev=prev, flow=flow, weight=weight,
    )
    fn = build.function("v2v_warp_blend", [_VOID] * 5 + [_INT] * 5 + [_VOID])
    b, c, h, w = prev.shape
    out = torch.empty_like(prev)
    err = build.launch(fn, prev.device, raw.data_ptr(), prev.data_ptr(), flow.data_ptr(),
                       weight.data_ptr(), out.data_ptr(), b, c, h, w, code)
    build.check(err, "warp_blend kernel launch")
    warp_blend.launches += 1
    return out


WARP_BLEND_OP = library.define(
    "warp_blend", "(Tensor raw, Tensor prev, Tensor flow, Tensor weight) -> Tensor",
    cpu=warp_blend_plain, cuda=_warp_blend_cuda,
    fake=lambda raw, prev, flow, weight: torch.empty_like(prev),
)


def warp_blend_bwd(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor,
    weight: torch.Tensor, g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """(d_raw, d_prev, d_flow, d_weight) of warp_blend for the cotangent g:
    the kernel `v2v_warp_blend_bwd` on a CUDA tensor (all five in one dtype,
    f32 or bf16, contiguous), `warp_blend_backward_plain` on a CPU tensor."""
    _check_blend(raw, prev, flow, weight)
    _check_backward(prev)
    if prev.device.type == "cpu":
        return warp_blend_backward_plain(raw, prev, flow, weight, g)
    code = build.require_cuda_operands(
        "warp_blend_bwd", prev.device, prev.dtype,
        raw=raw, prev=prev, flow=flow, weight=weight, g=g,
    )
    fn = build.function("v2v_warp_blend_bwd", [_VOID] * 10 + [_INT] * 5 + [_VOID])
    b, c, h, w = prev.shape
    dprev, splat = _splat_buffers(prev)
    draw, dflow, dweight = (torch.empty_like(t) for t in (raw, flow, weight))
    err = build.launch(fn, prev.device, raw.data_ptr(), prev.data_ptr(), flow.data_ptr(),
                       weight.data_ptr(), g.data_ptr(), draw.data_ptr(), dprev.data_ptr(),
                       splat.data_ptr(), dflow.data_ptr(), dweight.data_ptr(), b, c, h, w,
                       code)
    build.check(err, "warp_blend backward kernel launch")
    warp_blend_bwd.launches += 1
    warp_blend_bwd.second_kernels += prev.dtype == torch.bfloat16 and prev.numel() > 0  # the splat's cast
    return draw, dprev, dflow, dweight


warp_blend_bwd.launches = 0
warp_blend_bwd.second_kernels = 0  # the casts of the f32 splat to bf16


class _WarpBlend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw, prev, flow, weight):
        ctx.save_for_backward(raw, prev, flow, weight)
        return WARP_BLEND_OP(raw, prev, flow, weight)

    @staticmethod
    def backward(ctx, g):
        return warp_blend_bwd(*ctx.saved_tensors, g.contiguous())


def warp_blend(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """The temporal blend: raw * w + flow_warp(prev, flow) * (1 - w).

    raw, prev: (B, C, H, W); flow: (B, 2, H, W); weight: (B, 1, H, W).
    A CPU tensor takes `warp_blend_plain`; a CUDA tensor launches the kernel
    (all four in one dtype, f32 or bf16, contiguous) or raises. The
    gradient is `warp_blend_bwd`.
    """
    _check_blend(raw, prev, flow, weight)
    if wants_grad(raw, prev, flow, weight):
        return _WarpBlend.apply(raw, prev, flow, weight)
    return WARP_BLEND_OP(raw, prev, flow, weight)


warp_blend.launches = 0
