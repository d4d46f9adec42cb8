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
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.models.flownet2.flownet2 import FlowNet2
from vid2vid_tpu_torch.ops.resize import make_divisible, resize_bilinear
from vid2vid_tpu_torch.ops.warp import flow_warp
from vid2vid_tpu_torch.utils.precision import cudnn_f32


class FlowEstimator(nn.Module):
    """Frozen FlowNet2 + confidence (inference only)."""

    def __init__(self, conf_threshold: float = 0.02):
        super().__init__()
        self.net = FlowNet2()
        self.conf_threshold = conf_threshold

    @torch.no_grad()
    def forward(self, im1: torch.Tensor, im2: torch.Tensor):
        """Flow + confidence for (B, T, 3, H, W) or (B, 3, H, W) pairs.

        Returns (flow, conf), float32, shaped (..., 2, H, W) and (..., 1, H, W).
        """
        if im1.shape != im2.shape or im1.dim() not in (4, 5):
            raise ValueError(
                f"FlowEstimator: frames {tuple(im1.shape)} and {tuple(im2.shape)} "
                "must be equal (B, T, 3, H, W) or (B, 3, H, W)"
            )
        lead = im1.shape[:-3]
        flat = [im.reshape((-1,) + im.shape[-3:]).to(torch.float32).contiguous()
                for im in (im1, im2)]
        with cudnn_f32():
            flow, conf = self._compute(*flat)
        return flow.reshape(lead + flow.shape[1:]), conf.reshape(lead + conf.shape[1:])

    def _compute(self, im1: torch.Tensor, im2: torch.Tensor):
        old_h, old_w = im1.shape[-2:]
        new_h, new_w = make_divisible(old_h, 64), make_divisible(old_w, 64)
        resized = (old_h, old_w) != (new_h, new_w)
        if resized:
            im1 = resize_bilinear(im1, new_h, new_w)
            im2 = resize_bilinear(im2, new_h, new_w)

        flow = self.net(im1, im2)
        err = ((im1 - flow_warp(im2, flow)) ** 2).sum(1, keepdim=True)
        conf = (err < self.conf_threshold).to(flow.dtype)

        if resized:
            flow = resize_bilinear(flow, old_h, old_w) * (old_h / new_h)
            conf = resize_bilinear(conf, old_h, old_w)
        return flow, conf
