"""FlowNet2 and its C / CS / CSS variants (NCHW), the port of
vid2vid_tpu/models/flownet2/flownet2.py.

Reference dataflow (models/flownet2_pytorch/models.py:96-161): per-(image,
channel) mean over both frames subtracted -> FlowNetC -> (warp + diff +
channel norm) -> FlowNetS1 -> (the same) -> FlowNetS2 || FlowNetSD ->
FlowNetFusion over an 11-channel combination. div_flow = 20; the flow is
upsampled x4 bilinearly (align_corners=False) after C and S1, x4 nearest
after S2 and SD. The warps are vid2vid_tpu_torch.ops.warp.flow_warp (the
CUDA kernel on the card).

On training's model axis each cascade also runs on a width shard:
`forward(x1, x2, shard)`, the frames whole on every rank and shard the
split of their width (a multiple of 64), returns this rank's columns of
the flow. What every rank holds whole it computes whole: the means (no
collective) and the normalised pair that FlowNetC and FlowNetSD read. The
flow nets run on the shard (models/flownet2/nets.py), the x4 upsamplings
resize the rank's columns (ops/resize.py: the source columns fetched), the
warps sample the whole normalised x2 at the rank's column offset
(`flow_warp(x2, flow, x0)`) and the channel norms are per pixel. Without a
shard each cascade runs as it did, unsharded calls unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.models.flownet2.nets import (
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
)
from vid2vid_tpu_torch.ops.channelnorm import channel_norm
from vid2vid_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from vid2vid_tpu_torch.ops.warp import flow_warp
from vid2vid_tpu_torch.parallel import halo


def _mean_normalize(x1: torch.Tensor, x2: torch.Tensor, rgb_max: float = 1.0):
    """Subtract the per-(image, channel) mean over both frames."""
    mean = torch.stack([x1, x2], 2).mean(dim=(2, 3, 4), keepdim=True)[:, :, 0]
    return (x1 - mean) / rgb_max, (x2 - mean) / rgb_max


def _quarter(shard: halo.WidthShard | None) -> halo.WidthShard | None:
    """The shard of the flow nets' 1/4-resolution outputs."""
    return None if shard is None else shard.of_width(shard.total // 4)


def _up4_bilinear(flow: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
    """x4 bilinear; on a shard (the input's full width's), its columns."""
    return resize_bilinear(flow, flow.shape[-2] * 4, 4 * (flow.shape[-1] if shard is None
                                                          else shard.total // 4),
                           _quarter(shard))


def _up4_nearest(flow: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
    """x4 nearest; on a shard, its columns. At an integer factor torch's
    "nearest" picks the source pixel that jax.image.resize's "nearest"
    picks: floor(dst / 4)."""
    return resize_nearest(flow, flow.shape[-2] * 4, 4 * (flow.shape[-1] if shard is None
                                                         else shard.total // 4),
                          _quarter(shard))


def _run(net: nn.Module, x: torch.Tensor, shard: halo.WidthShard | None):
    """net(x), or net(x, shard) on a shard (the unsharded call unchanged)."""
    return net(x) if shard is None else net(x, shard)


def _warp(x2: torch.Tensor, flow: torch.Tensor, shard: halo.WidthShard | None):
    """flow_warp(x2, flow); on a shard, the whole x2 sampled at the rank's
    column offset."""
    return flow_warp(x2, flow) if shard is None else flow_warp(x2, flow, shard.x0)


def _warp_branch(x, x1, x2, flow, div_flow, shard=None):
    """[x, warp(x2, flow), flow / div_flow, ||x1 - warp(x2, flow)||]: the
    12-channel input of the next FlowNetS (on a shard, its columns: x, x1
    and x2 whole, flow the rank's columns)."""
    warped = _warp(x2, flow, shard)
    return torch.cat([halo.local(x, shard), warped, flow / div_flow,
                      channel_norm(halo.local(x1, shard) - warped)], 1)


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

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                shard: halo.WidthShard | None = None) -> torch.Tensor:
        """x1, x2: (B, 3, H, W) frame pair, H and W divisible by 64.

        Returns the (B, 2, H, W) flow that warps x2 toward x1; on a shard
        (of W), this rank's columns of it.
        """
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)
        x1_local = halo.local(x1, shard)

        (c_flow2,) = _run(self.flownetc, x, shard)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow, shard)

        (s1_flow2,) = _run(self.flownets_1,
                           _warp_branch(x, x1, x2, c_flow, self.div_flow, shard), shard)
        s1_flow = _up4_bilinear(s1_flow2 * self.div_flow, shard)

        # large-displacement branch
        (s2_flow2,) = _run(self.flownets_2,
                           _warp_branch(x, x1, x2, s1_flow, self.div_flow, shard), shard)
        s2_flow = _up4_nearest(s2_flow2 * self.div_flow, shard)
        diff_s2 = channel_norm(x1_local - _warp(x2, s2_flow, shard))

        # small-displacement branch
        (sd_flow2,) = _run(self.flownets_d, x, shard)
        sd_flow = _up4_nearest(sd_flow2 / self.div_flow, shard)
        diff_sd = channel_norm(x1_local - _warp(x2, sd_flow, shard))

        fusion_in = torch.cat(
            [x1_local, sd_flow, s2_flow, channel_norm(sd_flow), channel_norm(s2_flow),
             diff_sd, diff_s2],
            1,
        )
        return _run(self.flownetfusion, fusion_in, shard)


class FlowNet2C(nn.Module):
    """FlowNetC alone, full-resolution output (reference FlowNet2C)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                shard: halo.WidthShard | None = None) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        (flow2,) = _run(self.flownetc, torch.cat([x1, x2], 1), shard)
        return _up4_bilinear(flow2 * self.div_flow, shard)


class FlowNet2CS(nn.Module):
    """FlowNetC -> FlowNetS1 cascade (reference FlowNet2CS)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                shard: halo.WidthShard | None = None) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)
        (c_flow2,) = _run(self.flownetc, x, shard)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow, shard)
        (s1_flow2,) = _run(self.flownets_1,
                           _warp_branch(x, x1, x2, c_flow, self.div_flow, shard), shard)
        return _up4_bilinear(s1_flow2 * self.div_flow, shard)


class FlowNet2CSS(nn.Module):
    """FlowNetC -> S1 -> S2 cascade (reference FlowNet2CSS)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 1.0):
        super().__init__()
        self.div_flow = div_flow
        self.rgb_max = rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                shard: halo.WidthShard | None = None) -> torch.Tensor:
        x1, x2 = _mean_normalize(x1, x2, self.rgb_max)
        x = torch.cat([x1, x2], 1)
        (c_flow2,) = _run(self.flownetc, x, shard)
        c_flow = _up4_bilinear(c_flow2 * self.div_flow, shard)
        (s1_flow2,) = _run(self.flownets_1,
                           _warp_branch(x, x1, x2, c_flow, self.div_flow, shard), shard)
        s1_flow = _up4_bilinear(s1_flow2 * self.div_flow, shard)
        (s2_flow2,) = _run(self.flownets_2,
                           _warp_branch(x, x1, x2, s1_flow, self.div_flow, shard), shard)
        return _up4_bilinear(s2_flow2 * self.div_flow, shard)
