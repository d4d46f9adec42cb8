"""FlowNet2 and its C / CS / CSS variants (NCHW), the port of
vid2vid_tpu/models/flownet2/flownet2.py.

Reference dataflow (models/flownet2_pytorch/models.py:96-161): per-(image,
channel) mean over both frames subtracted -> FlowNetC -> (warp + diff +
channel norm) -> FlowNetS1 -> (the same) -> FlowNetS2 || FlowNetSD ->
FlowNetFusion over an 11-channel combination. div_flow = 20; the flow is
upsampled x4 bilinearly (align_corners=False) after C and S1, x4 nearest
after S2 and SD. The warps are vid2vid_tpu_torch.ops.warp.flow_warp (the
CUDA kernel on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vid2vid_tpu_torch.models.flownet2.nets import (
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
)
from vid2vid_tpu_torch.ops.channelnorm import channel_norm
from vid2vid_tpu_torch.ops.resize import resize_bilinear
from vid2vid_tpu_torch.ops.warp import flow_warp


def _mean_normalize(x1: torch.Tensor, x2: torch.Tensor, rgb_max: float = 1.0):
    """Subtract the per-(image, channel) mean over both frames."""
    mean = torch.stack([x1, x2], 2).mean(dim=(2, 3, 4), keepdim=True)[:, :, 0]
    return (x1 - mean) / rgb_max, (x2 - mean) / rgb_max


def _up4_bilinear(flow: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(flow, flow.shape[-2] * 4, flow.shape[-1] * 4)


def _up4_nearest(flow: torch.Tensor) -> torch.Tensor:
    # at an integer factor torch's "nearest" picks the source pixel that
    # jax.image.resize's "nearest" picks: floor(dst / 4)
    size = (flow.shape[-2] * 4, flow.shape[-1] * 4)
    return F.interpolate(flow, size=size, mode="nearest")


def _warp_branch(x, x1, x2, flow, div_flow):
    """[x, warp(x2, flow), flow / div_flow, ||x1 - warp(x2, flow)||]: the
    12-channel input of the next FlowNetS."""
    warped = flow_warp(x2, flow)
    return torch.cat([x, warped, flow / div_flow, channel_norm(x1 - warped)], 1)


class FlowNet2(nn.Module):
    """The full five-network FlowNet2 (162.5M parameters)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1, x2: (B, 3, H, W) frame pair, H and W divisible by 64.

        Returns the (B, 2, H, W) flow that warps x2 toward x1.
        """
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)

        (c_flow2,) = self.flownetc(x)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow)

        (s1_flow2,) = self.flownets_1(_warp_branch(x, x1, x2, c_flow, self.div_flow))
        s1_flow = _up4_bilinear(s1_flow2 * self.div_flow)

        # large-displacement branch
        (s2_flow2,) = self.flownets_2(_warp_branch(x, x1, x2, s1_flow, self.div_flow))
        s2_flow = _up4_nearest(s2_flow2 * self.div_flow)
        diff_s2 = channel_norm(x1 - flow_warp(x2, s2_flow))

        # small-displacement branch
        (sd_flow2,) = self.flownets_d(x)
        sd_flow = _up4_nearest(sd_flow2 / self.div_flow)
        diff_sd = channel_norm(x1 - flow_warp(x2, sd_flow))

        fusion_in = torch.cat(
            [x1, sd_flow, s2_flow, channel_norm(sd_flow), channel_norm(s2_flow),
             diff_sd, diff_s2],
            1,
        )
        return self.flownetfusion(fusion_in)


class FlowNet2C(nn.Module):
    """FlowNetC alone, full-resolution output (reference FlowNet2C)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        (flow2,) = self.flownetc(torch.cat([x1, x2], 1))
        return _up4_bilinear(flow2 * self.div_flow)


class FlowNet2CS(nn.Module):
    """FlowNetC -> FlowNetS1 cascade (reference FlowNet2CS)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)
        (c_flow2,) = self.flownetc(x)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow)
        (s1_flow2,) = self.flownets_1(_warp_branch(x, x1, x2, c_flow, self.div_flow))
        return _up4_bilinear(s1_flow2 * self.div_flow)


class FlowNet2CSS(nn.Module):
    """FlowNetC -> S1 -> S2 cascade (reference FlowNet2CSS)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)
        (c_flow2,) = self.flownetc(x)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow)
        (s1_flow2,) = self.flownets_1(_warp_branch(x, x1, x2, c_flow, self.div_flow))
        s1_flow = _up4_bilinear(s1_flow2 * self.div_flow)
        (s2_flow2,) = self.flownets_2(_warp_branch(x, x1, x2, s1_flow, self.div_flow))
        return _up4_bilinear(s2_flow2 * self.div_flow)
