"""The reference-flow estimator (the vid2vid `FlowNet` model), the port of
vid2vid_tpu/models/flownet2/wrapper.py.

Reference semantics (models/flownet.py:25-63):
  - resize the frame pair bilinearly to (h//64*64, w//64*64);
  - run FlowNet2;
  - confidence = (||im1 - warp(im2, flow)||^2 < 0.02), the norm being the
    channel *sum of squares* (no sqrt);
  - resize flow and confidence back, scaling the flow by old_h/new_h.
Takes (B, T, 3, H, W) frame stacks by flattening time, like the reference's
5-D path. Forward only, in float32, without gradients: the convolutions run
with cuDNN's TF32 off whatever the caller's setting (PyTorch's default lets
cuDNN use TF32); the net has no matmul.

On training's model axis (`forward(im1, im2, shard)`, the Trainer's
parallel/halo.py::WidthShard of the frames' width) every rank holds the
whole frames and computes this rank's columns of flow and confidence: the
resize to multiples of 64 whole (its input is whole), FlowNet2 on the
shard of that width (models/flownet2/flownet2.py), the confidence's warp
at the rank's column offset, and the resize back on the rank's columns
(ops/resize.py). Without a shard it is the unsharded path, unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.models.flownet2.flownet2 import FlowNet2
from vid2vid_tpu_torch.ops.resize import make_divisible, resize_bilinear
from vid2vid_tpu_torch.ops.warp import flow_warp
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.utils.precision import cudnn_f32


class FlowEstimator(nn.Module):
    """Frozen FlowNet2 + confidence (inference only)."""

    def __init__(self, conf_threshold: float = 0.02):
        super().__init__()
        self.net = FlowNet2()
        self.conf_threshold = conf_threshold

    @torch.no_grad()
    def forward(self, im1: torch.Tensor, im2: torch.Tensor,
                shard: halo.WidthShard | None = None):
        """Flow + confidence for (B, T, 3, H, W) or (B, 3, H, W) pairs.

        Returns (flow, conf), float32, shaped (..., 2, H, W) and (..., 1, H, W);
        on a shard of the width W (the frames whole), this rank's columns.
        """
        if im1.shape != im2.shape or im1.dim() not in (4, 5):
            raise ValueError(
                f"FlowEstimator: frames {tuple(im1.shape)} and {tuple(im2.shape)} "
                "must be equal (B, T, 3, H, W) or (B, 3, H, W)"
            )
        if shard is not None and shard.total != im1.shape[-1]:
            raise ValueError(f"FlowEstimator: a shard of width {shard.total} for frames "
                             f"{im1.shape[-1]} wide")
        lead = im1.shape[:-3]
        flat = [im.reshape((-1,) + im.shape[-3:]).to(torch.float32).contiguous()
                for im in (im1, im2)]
        flow, conf = self._compute(*flat, shard)
        return flow.reshape(lead + flow.shape[1:]), conf.reshape(lead + conf.shape[1:])

    @torch.no_grad()
    def flow_and_error(self, im1: torch.Tensor, im2: torch.Tensor,
                       shard: halo.WidthShard | None = None):
        """At FlowNet2's size (H and W cut to multiples of 64, the frames
        resized whole to it): (flow, the squared warp error that the
        confidence thresholds, the shard of that width), on a shard this
        rank's columns. (B, 3, H, W) frames, float32; cuDNN's TF32 off."""
        old_h, old_w = im1.shape[-2:]
        new_h, new_w = make_divisible(old_h, 64), make_divisible(old_w, 64)
        if (old_h, old_w) != (new_h, new_w):
            im1 = resize_bilinear(im1, new_h, new_w)
            im2 = resize_bilinear(im2, new_h, new_w)
        with cudnn_f32():
            if shard is None:
                flow = self.net(im1, im2)
                warped = flow_warp(im2, flow)
            else:
                shard = shard.of_width(new_w)
                flow = self.net(im1, im2, shard)
                warped = flow_warp(im2, flow, shard.x0)
        err = ((halo.local(im1, shard) - warped) ** 2).sum(1, keepdim=True)
        return flow, err, shard

    def _compute(self, im1: torch.Tensor, im2: torch.Tensor,
                 shard: halo.WidthShard | None = None):
        old_h, old_w = im1.shape[-2:]
        new_h, new_w = make_divisible(old_h, 64), make_divisible(old_w, 64)
        flow, err, net_shard = self.flow_and_error(im1, im2, shard)
        conf = (err < self.conf_threshold).to(flow.dtype)

        if (old_h, old_w) != (new_h, new_w):
            flow = resize_bilinear(flow, old_h, old_w, net_shard) * (old_h / new_h)
            conf = resize_bilinear(conf, old_h, old_w, net_shard)
        return flow, conf
