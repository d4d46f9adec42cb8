"""The FlowNet component networks as torch.nn modules (NCHW), the port of
vid2vid_tpu/models/flownet2/nets.py.

Architectures and state-dict names follow the reference (models/
flownet2_pytorch/networks/{FlowNetC,FlowNetS,FlowNetSD,FlowNetFusion}.py,
submodules.py; batchNorm=False, the configuration of the published
FlowNet2 checkpoint), which are the names vid2vid_tpu/utils/torch_import.py
maps:
  conv(k, s)  = Sequential(Conv2d(k, s, pad (k-1)//2), LeakyReLU(0.1))  -> conv1.0.weight
  deconv      = Sequential(ConvTranspose2d(4, 2, 1), LeakyReLU(0.1))   -> deconv5.0.weight
  i_conv      = Sequential(Conv2d(3, 1, 1))                            -> inter_conv5.0.weight
  predict_flow{l}            = Conv2d(3, 1, 1) to 2 channels
  upsampled_flow{l}_to_{l-1} = ConvTranspose2d(2, 2, 4, 2, 1), with no bias in FlowNetS.
FlowNetC's correlation is vid2vid_tpu_torch.ops.correlation (the CUDA
kernel on the card, forward and backward) followed by LeakyReLU(0.1). The
kernel takes f32 only, so under a bf16 forward (the flow harness's mixed
precision) its operands are cast to f32 and the cost volume back to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vid2vid_tpu_torch.ops.correlation import correlation


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2), nn.LeakyReLU(0.1)
    )


def _deconv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1))


def _i_conv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1))


def _predict_flow(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 2, 3, 1, 1)


def _upflow(bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


def _add_encoder6(net: nn.Module, cin: int) -> None:
    """conv3_1 .. conv6_1 of FlowNetC / FlowNetS, input at 1/8 resolution."""
    net.conv3_1 = _conv(cin, 256)
    net.conv4, net.conv4_1 = _conv(256, 512, stride=2), _conv(512, 512)
    net.conv5, net.conv5_1 = _conv(512, 512, stride=2), _conv(512, 512)
    net.conv6, net.conv6_1 = _conv(512, 1024, stride=2), _conv(1024, 1024)


def _encode6(net: nn.Module, x: torch.Tensor):
    c3_1 = net.conv3_1(x)
    c4_1 = net.conv4_1(net.conv4(c3_1))
    c5_1 = net.conv5_1(net.conv5(c4_1))
    return c3_1, c4_1, c5_1, net.conv6_1(net.conv6(c5_1))


def _add_decoder(net: nn.Module, upflow_bias: bool) -> None:
    """The FlowNetC / FlowNetS refinement decoder from 1/64 back to 1/4."""
    net.deconv5, net.deconv4 = _deconv(1024, 512), _deconv(1026, 256)
    net.deconv3, net.deconv2 = _deconv(770, 128), _deconv(386, 64)
    for lvl, cin in zip((6, 5, 4, 3, 2), (1024, 1026, 770, 386, 194)):
        setattr(net, f"predict_flow{lvl}", _predict_flow(cin))
    for lvl in (6, 5, 4, 3):
        setattr(net, f"upsampled_flow{lvl}_to_{lvl - 1}", _upflow(upflow_bias))


def _decode(net: nn.Module, o2, o3, o4, o5, o6):
    """Returns (flow2, flow3, flow4, flow5, flow6), finest first."""
    flow6 = net.predict_flow6(o6)
    concat5 = torch.cat([o5, net.deconv5(o6), net.upsampled_flow6_to_5(flow6)], 1)
    flow5 = net.predict_flow5(concat5)
    concat4 = torch.cat([o4, net.deconv4(concat5), net.upsampled_flow5_to_4(flow5)], 1)
    flow4 = net.predict_flow4(concat4)
    concat3 = torch.cat([o3, net.deconv3(concat4), net.upsampled_flow4_to_3(flow4)], 1)
    flow3 = net.predict_flow3(concat3)
    concat2 = torch.cat([o2, net.deconv2(concat3), net.upsampled_flow3_to_2(flow3)], 1)
    return net.predict_flow2(concat2), flow3, flow4, flow5, flow6


class FlowNetC(nn.Module):
    """Siamese encoder + correlation cost volume + refinement decoder.

    Input: (B, 6, H, W) stacked frame pair. Returns (flow2,) at 1/4
    resolution, or all five pyramid flows (finest first) with train_outputs.
    """

    def __init__(self, train_outputs: bool = False):
        super().__init__()
        self.train_outputs = train_outputs
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv_redir = _conv(256, 32, 1)
        _add_encoder6(self, 32 + 441)
        _add_decoder(self, upflow_bias=True)

    def forward(self, x: torch.Tensor):
        # one trunk, shared weights, run on both frames
        a2 = self.conv2(self.conv1(x[:, :3]))
        a3 = self.conv3(a2)
        b3 = self.conv3(self.conv2(self.conv1(x[:, 3:])))
        corr = correlation(a3.float().contiguous(), b3.float().contiguous()).to(a3.dtype)
        corr = F.leaky_relu(corr, 0.1)
        merged = torch.cat([self.conv_redir(a3), corr], 1)  # 473 channels
        flows = _decode(self, a2, *_encode6(self, merged))
        return flows if self.train_outputs else flows[:1]


class FlowNetS(nn.Module):
    """Plain encoder-decoder flow net (12-channel input inside FlowNet2)."""

    def __init__(self, input_channels: int = 12, train_outputs: bool = False):
        super().__init__()
        self.train_outputs = train_outputs
        self.conv1 = _conv(input_channels, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        _add_encoder6(self, 256)
        _add_decoder(self, upflow_bias=False)

    def forward(self, x: torch.Tensor):
        c2 = self.conv2(self.conv1(x))
        flows = _decode(self, c2, *_encode6(self, self.conv3(c2)))
        return flows if self.train_outputs else flows[:1]


class FlowNetSD(nn.Module):
    """Small-displacement variant: 3x3 encoder + inter-conv refinement."""

    def __init__(self, input_channels: int = 6, train_outputs: bool = False):
        super().__init__()
        self.train_outputs = train_outputs
        self.conv0 = _conv(input_channels, 64)
        self.conv1, self.conv1_1 = _conv(64, 64, stride=2), _conv(64, 128)
        self.conv2, self.conv2_1 = _conv(128, 128, stride=2), _conv(128, 128)
        self.conv3, self.conv3_1 = _conv(128, 256, stride=2), _conv(256, 256)
        self.conv4, self.conv4_1 = _conv(256, 512, stride=2), _conv(512, 512)
        self.conv5, self.conv5_1 = _conv(512, 512, stride=2), _conv(512, 512)
        self.conv6, self.conv6_1 = _conv(512, 1024, stride=2), _conv(1024, 1024)
        self.deconv5, self.deconv4 = _deconv(1024, 512), _deconv(1026, 256)
        self.deconv3, self.deconv2 = _deconv(770, 128), _deconv(386, 64)
        for lvl, (cin, cout) in zip(
            (5, 4, 3, 2), ((1026, 512), (770, 256), (386, 128), (194, 64))
        ):
            setattr(self, f"inter_conv{lvl}", _i_conv(cin, cout))
        for lvl, cin in zip((6, 5, 4, 3, 2), (1024, 512, 256, 128, 64)):
            setattr(self, f"predict_flow{lvl}", _predict_flow(cin))
        for lvl in (6, 5, 4, 3):
            setattr(self, f"upsampled_flow{lvl}_to_{lvl - 1}", _upflow())

    def forward(self, x: torch.Tensor):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))

        flow6 = self.predict_flow6(c6)
        concat5 = torch.cat([c5, self.deconv5(c6), self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(self.inter_conv5(concat5))
        concat4 = torch.cat(
            [c4, self.deconv4(concat5), self.upsampled_flow5_to_4(flow5)], 1
        )
        flow4 = self.predict_flow4(self.inter_conv4(concat4))
        concat3 = torch.cat(
            [c3, self.deconv3(concat4), self.upsampled_flow4_to_3(flow4)], 1
        )
        flow3 = self.predict_flow3(self.inter_conv3(concat3))
        concat2 = torch.cat(
            [c2, self.deconv2(concat3), self.upsampled_flow3_to_2(flow3)], 1
        )
        flow2 = self.predict_flow2(self.inter_conv2(concat2))
        flows = (flow2, flow3, flow4, flow5, flow6)
        return flows if self.train_outputs else flows[:1]


class FlowNetFusion(nn.Module):
    """Two-level fusion net over FlowNet2's 11-channel branch combination.
    Returns the full-resolution flow (one tensor)."""

    def __init__(self, input_channels: int = 11):
        super().__init__()
        self.conv0 = _conv(input_channels, 64)
        self.conv1, self.conv1_1 = _conv(64, 64, stride=2), _conv(64, 128)
        self.conv2, self.conv2_1 = _conv(128, 128, stride=2), _conv(128, 128)
        self.deconv1, self.deconv0 = _deconv(128, 32), _deconv(162, 16)
        self.inter_conv1, self.inter_conv0 = _i_conv(162, 32), _i_conv(82, 16)
        self.predict_flow2 = _predict_flow(128)
        self.predict_flow1, self.predict_flow0 = _predict_flow(32), _predict_flow(16)
        self.upsampled_flow2_to_1 = _upflow()
        self.upsampled_flow1_to_0 = _upflow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        concat1 = torch.cat([c1, self.deconv1(c2), self.upsampled_flow2_to_1(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat(
            [c0, self.deconv0(concat1), self.upsampled_flow1_to_0(flow1)], 1
        )
        return self.predict_flow0(self.inter_conv0(concat0))


def init_flownet_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference flow nets' own initialisation from a seeded generator:
    xavier-uniform conv and transposed-conv weights, U(0, 1) biases (the
    `init.xavier_uniform_` / `init.uniform_` loop at the end of each
    reference network's __init__)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                if m.bias is not None:
                    nn.init.uniform_(m.bias, generator=generator)
                nn.init.xavier_uniform_(m.weight, generator=generator)
