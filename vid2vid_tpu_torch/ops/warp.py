"""Bilinear flow warping and the warp + temporal blend (NCHW), with gradients.

`flow_warp(image, flow)` samples `image` at pixel coordinates (x + u, y + v),
bilinearly, with the coordinates clamped to the border: the semantics of
vid2vid_tpu/ops/warp.py::flow_warp_ref, computed with the same f32 floor /
clamp arithmetic. On a CUDA tensor it launches the hand-written kernel in
csrc/warp_blend.cu (the unfused entry `v2v_flow_warp_at`), on a CPU tensor
`flow_warp_plain`; FlowNet2 and its confidence, and the loss engine's warp
losses, call it unfused. `flow_warp(image, flow, x0)` is the warp of a
width shard (the loss engine's F_Warp and G_Warp on training's model axis):
image the whole (B, C, H, Wp) frame, flow the shard's W columns from the
frame's column x0, sampled at (x0 + x + u, y + v) and clamped to the whole
frame's border; its backward gives d_flow at the shard's columns and
d_image over the whole frame. The unsharded call is x0 = 0 with W = Wp.
A shard's launches (W < Wp) count on `flow_warp_at` / `flow_warp_at_bwd`,
the whole frame's on `flow_warp` / `flow_warp_bwd`. It equals the reference's
`F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
align_corners=True)` over a normalized [-1, 1] meshgrid plus the
normalized flow, up to the rounding of the normalization round trip
(tests/test_torch_ops.py holds the two together).

`warp_blend_at(raw, prev, flow, weight, x0)` is the blend of a width
shard (the model axis, parallel/halo.py): prev is the whole previous
frame, raw, flow and weight the shard's columns from the frame's column
x0, sampled at (x0 + x + u, y + v) and clamped to the whole frame's border
(the same kernel; `warp_blend_at_plain`). Its backward (`warp_blend_at_bwd`,
`warp_blend_at_backward_plain`) gives d_raw, d_flow and d_weight at the
shard's columns and d_prev over the whole frame (the shard's splat: the
ranks' d_prev sum to the whole frame's, parallel/halo.py::shared).

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
The backward is the kernel `v2v_flow_warp_at_bwd` / `v2v_warp_blend_bwd` on a
CUDA tensor (one ctypes call: the entry zeroes its f32 splat and, in bf16,
rounds it into d/dimage itself; both at a column offset, `Wp` and `x0`, as
their forwards) and `flow_warp_backward_plain` /
`warp_blend_backward_plain` / `warp_blend_at_backward_plain` on a CPU
tensor. It needs H and W (of the whole frame) of at least 2.

The forward kernel takes 2-D tiles of the output and stages each tile's
bounding box of prev in shared memory where it fits a budget, else gathers
from device memory (csrc/warp_blend.cu). `warp_forward_plan(C, dtype, H, W,
Wp)` chooses the tile and the budget, and the wrappers pass it to the entry;
`staged_tiles` mirrors each block's choice over a flow.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops import library
from vid2vid_tpu_torch.ops.conv7 import wants_grad


def _check_flow(image: torch.Tensor, flow: torch.Tensor, x0: int = 0) -> None:
    if (image.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2
            or image.shape[0] != flow.shape[0] or image.shape[2] != flow.shape[2]
            or not 0 <= x0 <= image.shape[3] - flow.shape[3]):
        raise ValueError(
            f"flow_warp: image {tuple(image.shape)} and flow {tuple(flow.shape)} "
            f"at x0 {x0}: they must share (B, H), flow must have 2 channels and "
            "its columns from x0 must lie within the image's"
        )


def _check_blend(raw, prev, flow, weight) -> None:
    s = prev.shape
    if (len(s) != 4 or raw.shape != s or flow.shape != (s[0], 2, s[2], s[3])
            or weight.shape != (s[0], 1, s[2], s[3])):
        raise ValueError(
            f"warp_blend: raw {tuple(raw.shape)}, prev {tuple(prev.shape)}, "
            f"flow {tuple(flow.shape)} and weight {tuple(weight.shape)} disagree"
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


def flow_warp_plain(image: torch.Tensor, flow: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy), in
    plain PyTorch (gathers); with x0, flow_warp's shard: image the whole
    (B, C, H, Wp) frame, flow its W columns from x0."""
    _check_flow(image, flow, x0)
    return _sample_plain(image, flow, x0)


def _sample_plain(image: torch.Tensor, flow: torch.Tensor, x0: int) -> torch.Tensor:
    """(B, C, H, Wp) image sampled at (x0 + x + u, y + v) for the (B, 2, H,
    W) flow's pixels, clamped to the image's border."""
    b, c, h, wp = image.shape
    w = flow.shape[3]
    ct = _work_dtype(flow)
    flow = flow.to(ct)
    ys = torch.arange(h, dtype=ct, device=image.device).view(1, h, 1)
    xs = torch.arange(w, dtype=ct, device=image.device).view(1, 1, w)
    if x0:
        xs = xs + x0
    x = xs + flow[:, 0]
    y = ys + flow[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).unsqueeze(1).to(image.dtype)
    wy = (y - y0).unsqueeze(1).to(image.dtype)
    # clamp before the int conversion: indices clamp to the same texels
    x0i = x0.clamp(-1, wp).long()
    y0i = y0.clamp(-1, h).long()
    x0c, x1c = x0i.clamp(0, wp - 1), (x0i + 1).clamp(0, wp - 1)
    y0c, y1c = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)

    flat = image.reshape(b, c, h * wp)

    def tap(yi, xi):
        idx = (yi * wp + xi).view(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).view(b, c, h, w)

    top = tap(y0c, x0c) * (1.0 - wx) + tap(y0c, x1c) * wx
    bot = tap(y1c, x0c) * (1.0 - wx) + tap(y1c, x1c) * wx
    return top * (1.0 - wy) + bot * wy


def warp_blend_plain(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """raw * w + flow_warp(prev, flow) * (1 - w) in plain PyTorch."""
    return raw * weight + flow_warp_plain(prev, flow) * (1.0 - weight)


def warp_blend_at_plain(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor,
    x0: int,
) -> torch.Tensor:
    """`warp_blend_at` in plain PyTorch: prev the whole frame, the others
    its columns from x0."""
    return raw * weight + _sample_plain(prev, flow, x0) * (1.0 - weight)


def _clip_grad(u: torch.Tensor) -> torch.Tensor:
    """d clip(u, 0, 1) / du as JAX gives it: 1 inside, 1/2 at a bound, 0
    beyond."""
    inside = ((u > 0) & (u < 1)).to(u.dtype)
    tie = ((u == 0) | (u == 1)).to(u.dtype)
    return inside + 0.5 * tie


def _patch_backward(image, flow, g, x0: int = 0):
    """The patch formulation's backward in the work dtype (f32, or f64 for
    f64 operands): returns (d/dimage (B, C, H, Wp), d/dflow (B, 2, H, W),
    the warped image (B, C, H, W)) for the (B, C, H, Wp) image sampled at
    (x0 + x + u, y + v) for the (B, 2, H, W) flow's pixels (x0 = 0 with Wp
    = W: the unsharded warp). `g` is the cotangent of the warp's output."""
    b, c, h, wp = image.shape
    w = flow.shape[3]
    dev = image.device
    ct = _work_dtype(image, flow, g)
    flow, img, gf = flow.to(ct), image.to(ct), g.to(ct)
    sy = torch.arange(h, dtype=ct, device=dev).view(1, h, 1) + flow[:, 1]
    sx = torch.arange(x0, x0 + w, dtype=ct, device=dev).view(1, 1, w) + flow[:, 0]
    y0 = torch.floor(sy).clamp(0, h - 2)
    xf = torch.floor(sx).clamp(0, wp - 2)
    uy, ux = sy - y0, sx - xf  # the fractional weights before their clip
    wy, wx = uy.clamp(0, 1).unsqueeze(1), ux.clamp(0, 1).unsqueeze(1)
    base = (y0.long() * wp + xf.long()).view(b, 1, h * w)
    flat = img.reshape(b, c, h * wp)
    offsets = (0, 1, wp, wp + 1)
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
    rows = (torch.arange(b, device=dev) * (h * wp)).view(b, 1)
    acc = torch.zeros(b * h * wp, c, dtype=ct, device=dev)
    for o, tw in zip(offsets, taps_w):
        idx = (rows + base.view(b, h * w) + o).reshape(-1)
        acc.index_add_(0, idx, (gf * tw).permute(0, 2, 3, 1).reshape(-1, c))
    dimage = acc.view(b, h, wp, c).permute(0, 3, 1, 2)
    return dimage, dflow, warped


def flow_warp_backward_plain(
    image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, x0: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, d/dflow) of flow_warp at (image, flow[, x0]) for the
    output cotangent g, in plain PyTorch, each in its input's dtype: on a
    shard d/dimage over the whole frame, d/dflow at the shard's columns."""
    _check_flow(image, flow, x0)
    _check_backward(image)
    dimage, dflow, _ = _patch_backward(image, flow, g, x0)
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
    return _blend_backward(raw, prev, flow, weight, g, 0)


def warp_blend_at_backward_plain(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor,
    weight: torch.Tensor, g: torch.Tensor, x0: int,
) -> tuple[torch.Tensor, ...]:
    """(d_raw, d_prev, d_flow, d_weight) of warp_blend_at for the cotangent
    g, in plain PyTorch: d_prev over the whole (B, C, H, Wp) frame, the
    others at the shard's columns."""
    _check_at(raw, prev, flow, weight, x0)
    _check_backward(prev)
    return _blend_backward(raw, prev, flow, weight, g, x0)


def _blend_backward(raw, prev, flow, weight, g, x0: int) -> tuple[torch.Tensor, ...]:
    ct = _work_dtype(raw, prev, flow, weight, g)
    gf, wf = g.to(ct), weight.to(ct)
    dprev, dflow, warped = _patch_backward(prev, flow, gf * (1 - wf), x0)
    draw = gf * wf
    dweight = (gf * (raw.to(ct) - warped)).sum(1, keepdim=True)
    return (draw.to(raw.dtype), dprev.to(prev.dtype), dflow.to(flow.dtype),
            dweight.to(weight.dtype))


# ------------------------------------------------------------------ kernels

_VOID = ctypes.c_void_p
_INT = ctypes.c_int


# csrc/warp_blend.cu's forward: a thread takes 4 adjacent pixels of a row
# on a staged tile (a budget), 2 on a direct one, a block at most
# FWD_THREADS threads (whole warps); a staged box at most MAX_BOX_BYTES of
# shared memory, its left edge and width whole groups of BOX_ALIGN_BYTES
FWD_THREADS = 256
MAX_BOX_BYTES = 226 * 1024
BOX_ALIGN_BYTES = 16


class WarpPlan(NamedTuple):
    rows: int  # a tile's rows
    cols: int  # a tile's columns
    smem_bytes: int  # the box budget a block (the launch's dynamic shared memory)
    align: int  # columns in 16 bytes: the box's left edge and width are multiples

    @property
    def pix(self) -> int:
        """Adjacent pixels a thread of a row: 4 on a staged tile, 2 on a
        direct one (the kernel's rule)."""
        return 4 if self.smem_bytes else 2


def plan_threads(plan: WarpPlan) -> int:
    """The threads of the kernel's block under `plan`, or 0 where the entry
    refuses it: columns whole threads of `plan.pix` pixels, 32 to
    FWD_THREADS threads in whole warps."""
    if plan.cols % plan.pix or plan.rows < 1:
        return 0
    threads = plan.rows * plan.cols // plan.pix
    return threads if 32 <= threads <= FWD_THREADS and threads % 32 == 0 else 0


# an image's C planes of prev from which the forward stages boxes: a third
# of the H100's 50 MB L2
STAGE_FROM_BYTES = 16 * 2**20


@functools.lru_cache(maxsize=256)
def warp_forward_plan(c: int, dtype: torch.dtype, h: int, w: int, wp: int) -> WarpPlan:
    """The forward kernel's tile and box budget for C channels of `dtype`
    sampled from an H x Wp frame at W output columns (the blend of a width
    shard: Wp > W; else Wp = W).

    Tile rows are 128 bytes of each stream (32 f32 or 64 bf16 columns).
    Where an image's C planes of prev take less than STAGE_FROM_BYTES, the
    gathers hit L2 and no box is staged: tiles of 512 pixels (16 x 32 in
    f32, 8 x 64 in bf16), 2 pixels a thread. From that size on, boxes are
    staged: tiles of 1024 pixels (32 x 32, 16 x 64), 4 pixels a thread, a
    budget of 32 KB (never more than the whole frame's C planes take).

    Chosen by `python -m vid2vid_tpu_torch.tools.warp_plans` on an H100
    (tiles from 1 x 512 to 32 x 64, budgets of 0 to 48 KB, i.i.d. and
    smooth flows, at the paths' shapes; PERF.md): staging paid only
    at FlowNet2's f32 warps, 2 x 25 MB of prev: by 2% on FlowNet2's own
    flows (`--flownet2`, the two plans in turns) and by 1-4% on the drawn
    smooth flow, against a 7% loss on the i.i.d. one; at the bf16 blends
    (12.6 MB at 1024 x 2048) the direct tiles matched or beat every staged
    one. A budget held by every block shrinks L1 and the blocks an SM
    holds, which the direct tiles of an incoherent flow pay for. Row strips
    (1 x 512, the layout before the tiles) lost or tied at every shape; no
    tile of this body recovers the parent's row strips at 256 x 512 bf16
    on a smooth flow (2-6% behind there)."""
    size = dtype.itemsize
    if c * h * wp * size < STAGE_FROM_BYTES:
        return tile_plan(dtype, staged=False)
    plan = tile_plan(dtype, staged=True)
    frame = c * h * math.ceil(wp / plan.align) * plan.align * size
    return plan._replace(smem_bytes=min(plan.smem_bytes, frame))


def tile_plan(dtype: torch.dtype, staged: bool) -> WarpPlan:
    """warp_forward_plan's two tiles in `dtype`, rows of 128 bytes: direct
    (512 pixels, 2 a thread, no budget) or staged (1024 pixels, 4 a
    thread, a budget of 32 KB)."""
    size = dtype.itemsize
    cols = 128 // size
    pixels, budget = (1024, 32 * 1024) if staged else (512, 0)
    return WarpPlan(pixels // cols, cols, budget, BOX_ALIGN_BYTES // size)


def staged_tiles(flow: torch.Tensor, plan: WarpPlan, c: int, wp: int | None = None,
                 x0: int = 0) -> int:
    """How many of the kernel's tiles take the staged path for this (B, 2,
    H, W) flow under `plan`, C channels sampled from an H x Wp frame from
    column x0: each tile's corners (clamped as the sample clamps them)
    reduced to their box, its left edge aligned down and its width rounded
    up to `plan.align` columns, staged where C planes of it fit
    `plan.smem_bytes`. A plain mirror of the block's decision, the same
    f32 arithmetic."""
    b, _, h, w = flow.shape
    wp = w if wp is None else wp
    f = flow.detach().to("cpu", torch.float32)
    sx = torch.arange(x0, x0 + w, dtype=torch.float32).view(1, 1, w) + f[:, 0]
    sy = torch.arange(h, dtype=torch.float32).view(1, h, 1) + f[:, 1]
    xi = torch.floor(sx).clamp(-1, wp).long()
    yi = torch.floor(sy).clamp(-1, h).long()
    ty, tx = math.ceil(h / plan.rows), math.ceil(w / plan.cols)

    def tiles(v, pad, reduce):
        v = torch.nn.functional.pad(v, (0, tx * plan.cols - w, 0, ty * plan.rows - h),
                                    value=pad)
        return reduce(v.view(b, ty, plan.rows, tx, plan.cols), dim=(2, 4))

    big = 1 << 40
    xmin = tiles(xi.clamp(0, wp - 1), big, torch.amin)
    xmax = tiles((xi + 1).clamp(0, wp - 1), -1, torch.amax)
    ymin = tiles(yi.clamp(0, h - 1), big, torch.amin)
    ymax = tiles((yi + 1).clamp(0, h - 1), -1, torch.amax)
    a = plan.align
    bx0 = xmin // a * a
    sw = (xmax + 1 - bx0 + a - 1) // a * a
    box = c * (ymax + 1 - ymin) * sw * (BOX_ALIGN_BYTES // a)
    return int((box <= plan.smem_bytes).sum())


_FLOW_WARP_ARGS = [_VOID] * 3 + [_INT] * 9 + [_VOID, _INT, _VOID]
_WARP_BLEND_ARGS = [_VOID] * 5 + [_INT] * 9 + [_VOID, _INT, _VOID]


def warp_forward_cuda(prev: torch.Tensor, flow: torch.Tensor, raw: torch.Tensor | None = None,
                      weight: torch.Tensor | None = None, x0: int = -1,
                      plan: WarpPlan | None = None,
                      staged: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors: `v2v_flow_warp_at`
    (no raw), else `v2v_warp_blend`, at column x0 of the whole prev (x0 < 0:
    the unsharded blend), under `plan` (default: warp_forward_plan's).
    `staged`, an int32 tensor of one element, adds the launch's staged
    tiles. Counted on flow_warp (the whole frame) or flow_warp_at (a
    shard's columns), warp_blend or warp_blend_at (x0 >= 0)."""
    b, c, h, w = prev.shape[:2] + flow.shape[2:]  # the output's: the flow's columns
    if w == 0:  # a width shard with no columns at this level: no launch
        return prev.new_empty((b, c, h, 0))
    wp = prev.shape[3]
    plan = plan or warp_forward_plan(c, prev.dtype, h, w, wp)
    tensors = dict(prev=prev, flow=flow) if raw is None else dict(
        raw=raw, prev=prev, flow=flow, weight=weight)
    what = "flow_warp" if raw is None else "warp_blend"
    code = build.require_cuda_operands(what, prev.device, prev.dtype, **tensors)
    if staged is not None and (staged.dtype != torch.int32 or staged.device != prev.device):
        raise ValueError(f"{what}: the staged count must be an int32 tensor on {prev.device}")
    out = prev.new_empty((b, c, h, w))
    count = staged.data_ptr() if staged is not None else None
    tile = (plan.rows, plan.cols, plan.smem_bytes, count, code)
    if raw is None:
        fn = build.function("v2v_flow_warp_at", _FLOW_WARP_ARGS)
        err = build.launch(fn, prev.device, prev.data_ptr(), flow.data_ptr(), out.data_ptr(),
                           b, c, h, w, wp, max(x0, 0), *tile)
        counter = flow_warp if w == wp else flow_warp_at
    else:
        fn = build.function("v2v_warp_blend", _WARP_BLEND_ARGS)
        err = build.launch(fn, prev.device, raw.data_ptr(), prev.data_ptr(), flow.data_ptr(),
                           weight.data_ptr(), out.data_ptr(), b, c, h, w, wp, max(x0, 0),
                           *tile)
        counter = warp_blend if x0 < 0 else warp_blend_at
    build.check(err, f"{what} kernel launch")
    counter.launches += 1
    return out


def _flow_warp_forward(image: torch.Tensor, flow: torch.Tensor, x0: int) -> torch.Tensor:
    if image.device.type == "cpu":
        return flow_warp_plain(image, flow, x0)
    return warp_forward_cuda(image, flow, x0=x0)


def _splat_buffers(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, the f32 buffer the kernel's splat accumulates into), both
    uninitialised: the C entry zeroes the buffer and, in bf16, rounds it
    into d/dimage; in f32 the two are one tensor."""
    dimage = torch.empty_like(image)
    if image.dtype == torch.float32:
        return dimage, dimage
    return dimage, torch.empty(image.shape, dtype=torch.float32, device=image.device)


def flow_warp_bwd(
    image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor, x0: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dimage, d/dflow) of flow_warp for the cotangent g: the kernel
    `v2v_flow_warp_at_bwd` on a CUDA tensor (all three in one dtype, f32 or
    bf16, contiguous), `flow_warp_backward_plain` on a CPU tensor. On a
    shard (flow and g its columns from x0) d/dimage is over the whole frame
    (the shard's splat: the shards' sum to the whole frame's); with no
    columns no kernel runs and d/dimage is zeros."""
    _check_flow(image, flow, x0)
    _check_backward(image)
    if flow.shape[3] == 0:
        return torch.zeros_like(image), torch.empty_like(flow)
    if image.device.type == "cpu":
        return flow_warp_backward_plain(image, flow, g, x0)
    code = build.require_cuda_operands(
        "flow_warp_bwd", image.device, image.dtype, image=image, flow=flow, g=g
    )
    fn = build.function("v2v_flow_warp_at_bwd", [_VOID] * 6 + [_INT] * 7 + [_VOID])
    b, c, h, wp = image.shape
    w = flow.shape[3]
    dimage, splat = _splat_buffers(image)
    dflow = torch.empty_like(flow)
    err = build.launch(fn, image.device, image.data_ptr(), flow.data_ptr(), g.data_ptr(),
                       dimage.data_ptr(), splat.data_ptr(), dflow.data_ptr(), b, c, h, w, wp,
                       x0, code)
    build.check(err, "flow_warp backward kernel launch")
    counter = flow_warp_bwd if w == wp else flow_warp_at_bwd
    counter.launches += 1
    counter.second_kernels += image.dtype == torch.bfloat16 and image.numel() > 0  # the cast
    return dimage, dflow


class _FlowWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, flow, x0):
        ctx.save_for_backward(image, flow)
        ctx.x0 = x0
        return _flow_warp_forward(image, flow, x0)

    @staticmethod
    def backward(ctx, g):
        image, flow = ctx.saved_tensors
        return (*flow_warp_bwd(image, flow, g.contiguous(), ctx.x0), None)


def flow_warp(image: torch.Tensor, flow: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """(B, C, H, W) image warped by (B, 2, H, W) pixel flow (dx, dy); with
    x0, a width shard's (image the whole (B, C, H, Wp) frame, flow its W
    columns from the frame's column x0: the shard's columns of the whole
    warp).

    A CPU tensor takes `flow_warp_plain`; a CUDA tensor launches the kernel
    (image and flow in one dtype, f32 or bf16, contiguous) or raises. The
    gradient is `flow_warp_bwd`.
    """
    _check_flow(image, flow, x0)
    if wants_grad(image, flow):
        return _FlowWarp.apply(image, flow, x0)
    return _flow_warp_forward(image, flow, x0)


def flow_warp_at(image: torch.Tensor, flow: torch.Tensor, x0: int) -> torch.Tensor:
    """flow_warp of a width shard's columns from x0; the launches of every
    flow_warp call on a shard (W < Wp) count here."""
    return flow_warp(image, flow, x0)


def flow_warp_at_bwd(image: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                     x0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """flow_warp_bwd of a width shard's columns from x0; the launches of
    every flow_warp_bwd call on a shard count here."""
    return flow_warp_bwd(image, flow, g, x0)


flow_warp.launches = flow_warp_at.launches = 0
for _counter in (flow_warp_bwd, flow_warp_at_bwd):
    _counter.launches = 0
    _counter.second_kernels = 0  # the casts of the f32 splat to bf16


def _warp_blend_cuda(raw, prev, flow, weight, x0=-1) -> torch.Tensor:
    """The operator's CUDA implementation: one launch of the kernel (with
    x0 >= 0, at that column offset)."""
    return warp_forward_cuda(prev, flow, raw, weight, x0)


def _warp_blend_plain(raw, prev, flow, weight, x0=-1) -> torch.Tensor:
    if x0 < 0:
        return warp_blend_plain(raw, prev, flow, weight)
    return warp_blend_at_plain(raw, prev, flow, weight, x0)


# x0 >= 0: a width shard's blend at that column of the whole previous
# frame (`warp_blend_at`)
WARP_BLEND_OP = library.define(
    "warp_blend", "(Tensor raw, Tensor prev, Tensor flow, Tensor weight, int x0=-1) -> Tensor",
    cpu=_warp_blend_plain, cuda=_warp_blend_cuda,
    fake=lambda raw, prev, flow, weight, x0=-1: torch.empty_like(raw),
)


def _warp_blend_bwd_cuda(raw, prev, flow, weight, g, x0: int, counter) -> tuple:
    """One call of the kernel's entry `v2v_warp_blend_bwd` (at column
    offset x0 of the whole (B, C, H, Wp) prev), counted on `counter`."""
    code = build.require_cuda_operands(
        counter.__name__, prev.device, prev.dtype,
        raw=raw, prev=prev, flow=flow, weight=weight, g=g,
    )
    fn = build.function("v2v_warp_blend_bwd", [_VOID] * 10 + [_INT] * 7 + [_VOID])
    b, c, h, w = raw.shape
    dprev, splat = _splat_buffers(prev)
    draw, dflow, dweight = (torch.empty_like(t) for t in (raw, flow, weight))
    err = build.launch(fn, prev.device, raw.data_ptr(), prev.data_ptr(), flow.data_ptr(),
                       weight.data_ptr(), g.data_ptr(), draw.data_ptr(), dprev.data_ptr(),
                       splat.data_ptr(), dflow.data_ptr(), dweight.data_ptr(), b, c, h, w,
                       prev.shape[3], x0, code)
    build.check(err, f"{counter.__name__} kernel launch")
    counter.launches += 1
    counter.second_kernels += prev.dtype == torch.bfloat16 and prev.numel() > 0  # the splat's cast
    return draw, dprev, dflow, dweight


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
    return _warp_blend_bwd_cuda(raw, prev, flow, weight, g, 0, warp_blend_bwd)


warp_blend_bwd.launches = 0
warp_blend_bwd.second_kernels = 0  # the casts of the f32 splat to bf16


def warp_blend_at_bwd(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor,
    weight: torch.Tensor, g: torch.Tensor, x0: int,
) -> tuple[torch.Tensor, ...]:
    """(d_raw, d_prev, d_flow, d_weight) of warp_blend_at for the cotangent
    g: the kernel `v2v_warp_blend_bwd` at column offset x0 on a CUDA tensor
    (all five in one dtype, f32 or bf16, contiguous; d_prev over the whole
    frame), `warp_blend_at_backward_plain` on a CPU tensor. At x0 = 0 with
    Wp = W it is `warp_blend_bwd`, bit for bit on the card. With no
    columns (W = 0: a shard with none at this level) no kernel runs and
    d_prev is zeros."""
    _check_at(raw, prev, flow, weight, x0)
    _check_backward(prev)
    if raw.shape[3] == 0:
        return (torch.empty_like(raw), torch.zeros_like(prev), torch.empty_like(flow),
                torch.empty_like(weight))
    if prev.device.type == "cpu":
        return warp_blend_at_backward_plain(raw, prev, flow, weight, g, x0)
    return _warp_blend_bwd_cuda(raw, prev, flow, weight, g, x0, warp_blend_at_bwd)


warp_blend_at_bwd.launches = 0
warp_blend_at_bwd.second_kernels = 0  # the casts of the f32 splat to bf16


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


def _check_at(raw, prev, flow, weight, x0: int) -> None:
    b, c, h, w = raw.shape
    if (prev.shape[:3] != raw.shape[:3] or flow.shape != (b, 2, h, w)
            or weight.shape != (b, 1, h, w) or not 0 <= x0 <= prev.shape[3] - w):
        raise ValueError(f"warp_blend_at: raw {tuple(raw.shape)}, prev {tuple(prev.shape)}, "
                         f"flow {tuple(flow.shape)}, weight {tuple(weight.shape)}, x0 {x0}")


class _WarpBlendAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw, prev, flow, weight, x0):
        ctx.save_for_backward(raw, prev, flow, weight)
        ctx.x0 = x0
        return WARP_BLEND_OP(raw, prev, flow, weight, x0)

    @staticmethod
    def backward(ctx, g):
        return (*warp_blend_at_bwd(*ctx.saved_tensors, g.contiguous(), ctx.x0), None)


def warp_blend_at(
    raw: torch.Tensor, prev: torch.Tensor, flow: torch.Tensor, weight: torch.Tensor,
    x0: int,
) -> torch.Tensor:
    """The blend of a width shard: prev (B, C, H, Wp) the whole previous
    frame, raw (B, C, H, W), flow (B, 2, H, W) and weight (B, 1, H, W) its
    columns from the frame's column x0: raw * w + warp * (1 - w), the warp
    sampling prev at (x0 + x + u, y + v), clamped to the whole frame's
    border. At x0 = 0 with Wp = W it is `warp_blend`, bit for bit on the
    card. A CPU tensor takes `warp_blend_at_plain`. The gradient is
    `warp_blend_at_bwd`."""
    _check_at(raw, prev, flow, weight, x0)
    if wants_grad(raw, prev, flow, weight):
        return _WarpBlendAt.apply(raw, prev, flow, weight, x0)
    return WARP_BLEND_OP(raw, prev, flow, weight, x0)


warp_blend.launches = 0
warp_blend_at.launches = 0
