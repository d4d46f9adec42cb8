"""Bilinear flow warping and the warp + temporal blend (NCHW).

`flow_warp(image, flow)` samples `image` at pixel coordinates (x + u, y + v),
bilinearly, with the coordinates clamped to the border: the semantics of
vid2vid_tpu/ops/warp.py::flow_warp_ref, computed with the same f32 floor /
clamp arithmetic. On a CUDA tensor it launches the hand-written kernel in
csrc/warp_blend.cu (the unfused entry `v2v_flow_warp`), on a CPU tensor
`flow_warp_plain`; FlowNet2 and its confidence call it unfused. It equals
the reference's
`F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
align_corners=True)` over a normalized [-1, 1] meshgrid plus the
normalized flow, up to the rounding of the normalization round trip
(tests/test_torch_ops.py holds the two together).

`warp_blend(raw, prev, flow, weight)` is the composite generator's blend
`raw * w + flow_warp(prev, flow) * (1 - w)` (vid2vid_tpu/nn/composite.py::
_blend): the hand-written CUDA kernel csrc/warp_blend.cu on a CUDA tensor,
`warp_blend_plain` on a CPU tensor. Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from vid2vid_tpu_torch.kernels import build


def _check_flow(image: torch.Tensor, flow: torch.Tensor) -> None:
    if (
        image.dim() != 4
        or flow.dim() != 4
        or flow.shape[1] != 2
        or image.shape[0] != flow.shape[0]
        or image.shape[2:] != flow.shape[2:]
    ):
        raise ValueError(
            f"flow_warp: image {tuple(image.shape)} and flow "
            f"{tuple(flow.shape)} must share (B, H, W) and flow must have "
            "2 channels"
        )


def flow_warp_plain(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy), in
    plain PyTorch (gathers)."""
    _check_flow(image, flow)
    b, c, h, w = image.shape
    flow = flow.float()
    ys = torch.arange(h, dtype=torch.float32, device=image.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=image.device).view(1, 1, w)
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


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def flow_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy).

    A CPU tensor takes `flow_warp_plain`; a CUDA tensor launches the kernel
    (image and flow in one dtype, f32 or bf16, contiguous) or raises.
    """
    _check_flow(image, flow)
    if image.device.type == "cpu":
        return flow_warp_plain(image, flow)
    code = build.require_cuda_operands(
        "flow_warp", image.device, image.dtype, image=image, flow=flow
    )
    fn = build.function("v2v_flow_warp", [_VOID] * 3 + [_INT] * 5 + [_VOID])
    b, c, h, w = image.shape
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):  # launch on the operands' card
        err = fn(
            image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, c, h, w, code,
            torch.cuda.current_stream(image.device).cuda_stream,
        )
    build.check(err, "flow_warp kernel launch")
    flow_warp.launches += 1
    return out


flow_warp.launches = 0


def warp_blend(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """The temporal blend: raw * w + flow_warp(prev, flow) * (1 - w).

    raw, prev: (B, C, H, W); flow: (B, 2, H, W); weight: (B, 1, H, W).
    A CPU tensor takes `warp_blend_plain`; a CUDA tensor launches the kernel
    (all four in one dtype, f32 or bf16, contiguous) or raises.
    """
    _check_flow(prev, flow)
    b, c, h, w = prev.shape
    if raw.shape != prev.shape or weight.shape != (b, 1, h, w):
        raise ValueError(
            f"warp_blend: raw {tuple(raw.shape)}, prev {tuple(prev.shape)} "
            f"and weight {tuple(weight.shape)} disagree"
        )
    if prev.device.type == "cpu":
        return warp_blend_plain(raw, prev, flow, weight)
    code = build.require_cuda_operands(
        "warp_blend", prev.device, prev.dtype,
        raw=raw, prev=prev, flow=flow, weight=weight,
    )
    fn = build.function("v2v_warp_blend", [_VOID] * 5 + [_INT] * 5 + [_VOID])
    out = torch.empty_like(prev)
    with torch.cuda.device(prev.device):  # launch on the operands' card
        err = fn(
            raw.data_ptr(), prev.data_ptr(), flow.data_ptr(), weight.data_ptr(),
            out.data_ptr(), b, c, h, w, code,
            torch.cuda.current_stream(prev.device).cuda_stream,
        )
    build.check(err, "warp_blend kernel launch")
    warp_blend.launches += 1
    return out


warp_blend.launches = 0
