"""Plain PyTorch reference of vid2vid's streaming label-to-video generator.

The semantics of NVIDIA vid2vid's test path (models/networks.py:
CompositeGenerator at the coarsest spatial scale, CompositeLocalGenerator
at each finer one; models/vid2vid_model_G.py: the label one-hot with its
instance-edge channel, the 3x3/s2 average pyramid, the frame-by-frame
loop over a window of tG label maps and the tG - 1 frames generated
before), written with torch.nn's own layers, in float32, with no kernel,
cache or packing. It imports nothing of the program it judges.

The state-dict names are the reference's (each Sequential's indices), so
one dict of seeded tensors loads into this module and into the program.
Eval mode throughout: batch norm normalises by its running statistics.

`fp8=True` is the benchmark's control: every convolution's input and
weight rounded to float8 e4m3 (per-tensor scale from the absolute maximum)
before an f32 convolution, the nearest precision below the bfloat16 the
configuration states.

Every operation runs on the `meta` device too, so `work.py` can count a
step's operations without computing it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest float8 e4m3fn value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its absolute
    maximum onto FP8_MAX), returned in x's dtype."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class Conv2d(nn.Conv2d):
    """nn.Conv2d, whose input and weight are rounded to float8 while the
    module's `fp8` is set (the control)."""

    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d(3, 2, padding 1, output_padding 1), rounded to
    float8 as Conv2d is while `fp8` is set."""

    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return F.conv_transpose2d(fp8_round(x), fp8_round(self.weight), self.bias,
                                  self.stride, self.padding, self.output_padding)


def reflect_conv(cin: int, cout: int, k: int) -> list[nn.Module]:
    return [nn.ReflectionPad2d(k // 2), Conv2d(cin, cout, k)]


def conv_stem(cin: int, cout: int) -> list[nn.Module]:
    return [*reflect_conv(cin, cout, 7), nn.BatchNorm2d(cout), nn.ReLU(True)]


def down_block(cin: int, cout: int) -> list[nn.Module]:
    return [Conv2d(cin, cout, 3, stride=2, padding=1), nn.BatchNorm2d(cout), nn.ReLU(True)]


def up_block(cin: int, cout: int) -> list[nn.Module]:
    return [ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1),
            nn.BatchNorm2d(cout), nn.ReLU(True)]


class ResnetBlock(nn.Module):
    """x + BN(conv3(ReLU(BN(conv3(x))))), both convs reflect-padded."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            *reflect_conv(dim, dim, 3), nn.BatchNorm2d(dim), nn.ReLU(True),
            *reflect_conv(dim, dim, 3), nn.BatchNorm2d(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


def trunk(cin: int, ngf: int, n_down: int) -> list[nn.Module]:
    layers = conv_stem(cin, ngf)
    for i in range(n_down):
        layers += down_block(ngf * 2**i, ngf * 2 ** (i + 1))
    return layers


def ups(ngf: int, n_up: int) -> list[nn.Module]:
    layers: list[nn.Module] = []
    for i in range(n_up):
        layers += up_block(ngf * 2 ** (n_up - i), ngf * 2 ** (n_up - 1 - i))
    return layers


def resblocks(dim: int, n: int) -> list[nn.Module]:
    return [ResnetBlock(dim) for _ in range(n)]


def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """image (B, C, H, W) sampled bilinearly at (x + u, y + v) for the
    pixel flow (B, 2, H, W), clamped to the border: grid_sample on the
    normalised grid, as the reference's Resample2d / grid_sample warp."""
    b, _, h, w = image.shape
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device).view(1, h, 1)
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device).view(1, 1, w)
    gx = (xs + flow[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys + flow[:, 1]) * (2.0 / (h - 1)) - 1.0
    grid = torch.stack([gx, gy], -1)
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


class Heads(nn.Module):
    def heads(self, ngf: int, ngf_i: int, out_nc: int) -> None:
        self.model_final_img = nn.Sequential(*reflect_conv(ngf, out_nc, 7), nn.Tanh())
        self.model_final_flow = nn.Sequential(*reflect_conv(ngf, 2, 7))
        self.model_final_w = nn.Sequential(*reflect_conv(ngf, 1, 7), nn.Sigmoid())
        self.indv_final = nn.Sequential(*reflect_conv(ngf_i, out_nc, 7), nn.Tanh())

    def compose(self, prev, mask, img_feat, flow_feat, fg_feat, flow_mult):
        """The heads, the warp of the last previous frame blended with the
        hallucinated frame by the occlusion weight, then the foreground
        composited by the mask: (frame, img_feat, flow_feat, fg_feat)."""
        raw = self.model_final_img(img_feat)
        flow = self.model_final_flow(flow_feat) * flow_mult
        weight = self.model_final_w(flow_feat)
        last = prev[:, -raw.shape[1]:]
        frame = raw * weight + warp(last, flow) * (1.0 - weight)
        fg = self.indv_final(fg_feat)
        frame = fg * mask + frame * (1.0 - mask)
        return frame, img_feat, flow_feat, fg_feat


class CompositeGenerator(Heads):
    """The coarsest scale: label and previous-frame trunks summed, an
    image branch, a flow branch and a foreground branch."""

    def __init__(self, in_nc: int, prev_nc: int, out_nc: int, ngf: int, n_down: int,
                 n_blocks: int):
        super().__init__()
        ch = ngf * 2**n_down
        ngf_i = ngf // 2 if n_down > 2 else ngf
        n_res_down, n_res_up = n_blocks - n_blocks // 2, n_blocks // 2
        self.model_down_seg = nn.Sequential(*trunk(in_nc, ngf, n_down),
                                            *resblocks(ch, n_res_down))
        self.model_down_img = nn.Sequential(*trunk(prev_nc, ngf, n_down),
                                            *resblocks(ch, n_res_down))
        self.model_res_img = nn.Sequential(*resblocks(ch, n_res_up))
        self.model_up_img = nn.Sequential(*ups(ngf, n_down))
        self.model_res_flow = nn.Sequential(*resblocks(ch, n_res_up))
        self.model_up_flow = nn.Sequential(*ups(ngf, n_down))
        self.indv_down = nn.Sequential(*trunk(in_nc, ngf_i, n_down))
        self.indv_res = nn.Sequential(*resblocks(ngf_i * 2**n_down, n_blocks))
        self.indv_up = nn.Sequential(*ups(ngf_i, n_down))
        self.heads(ngf, ngf_i, out_nc)

    def forward(self, labels, prev, mask, coarse=None):
        d = self.model_down_seg(labels) + self.model_down_img(prev)
        img_feat = self.model_up_img(self.model_res_img(d))
        flow_feat = self.model_up_flow(self.model_res_flow(d))
        fg_feat = self.indv_up(self.indv_res(self.indv_down(labels)))
        return self.compose(prev, mask, img_feat, flow_feat, fg_feat, 20.0)


class CompositeLocalGenerator(Heads):
    """A finer scale: one-downsample trunks, the coarser scale's features
    added before its residual and upsampling stages."""

    def __init__(self, in_nc: int, prev_nc: int, out_nc: int, ngf: int, n_blocks_local: int,
                 n_down_global: int, scale: int):
        super().__init__()
        ngf_i = ngf // 2 if n_down_global > 2 else ngf
        self.scale = scale

        def up_stack(width):
            return nn.Sequential(*resblocks(2 * width, n_blocks_local), *ups(width, 1))

        self.model_down_seg = nn.Sequential(*trunk(in_nc, ngf, 1))
        self.model_down_img = nn.Sequential(*trunk(prev_nc, ngf, 1))
        self.model_up_img = up_stack(ngf)
        self.model_up_flow = up_stack(ngf)
        self.indv_down = nn.Sequential(*trunk(in_nc, ngf_i, 1))
        self.indv_up = up_stack(ngf_i)
        self.heads(ngf, ngf_i, out_nc)

    def forward(self, labels, prev, mask, coarse):
        _, c_img, c_flow, c_fg = coarse
        d = self.model_down_seg(labels) + self.model_down_img(prev)
        img_feat = self.model_up_img(d + c_img)
        flow_feat = self.model_up_flow(d + c_flow)
        fg_feat = self.indv_up(self.indv_down(labels) + c_fg)
        return self.compose(prev, mask, img_feat, flow_feat, fg_feat, 20.0 * 2**self.scale)


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(..., H, W) integer labels -> (..., n, H, W) float32 one-hot (a
    label outside [0, n) gives zeros)."""
    classes = torch.arange(n, device=labels.device).view(n, 1, 1)
    return (labels.unsqueeze(-3).long() == classes).float()


def instance_edges(inst: torch.Tensor) -> torch.Tensor:
    """(..., H, W) instance ids -> (..., H, W) float32: 1 where a pixel
    differs from a 4-neighbour (the reference's get_edges)."""
    dx = (inst[..., :, 1:] != inst[..., :, :-1]).float()
    dy = (inst[..., 1:, :] != inst[..., :-1, :]).float()
    ex = torch.maximum(F.pad(dx, (1, 0)), F.pad(dx, (0, 1)))
    ey = torch.maximum(F.pad(dy, (0, 0, 1, 0)), F.pad(dy, (0, 0, 0, 1)))
    return torch.maximum(ex, ey)


def pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class Vid2VidReference(nn.Module):
    """The scale stack G0 (coarsest) .. G{n-1} (finest) of one
    configuration (the keys of configs/<name>.json's "options")."""

    def __init__(self, opt: dict):
        super().__init__()
        self.label_nc, self.tG = opt["label_nc"], opt["n_frames_G"]
        self.n_scales, self.fg_labels = opt["n_scales_spatial"], list(opt["fg_labels"])
        self.out_nc = 3
        in_nc = (self.label_nc + 1) * self.tG  # one-hot + instance edges, tG frames
        prev_nc = (self.tG - 1) * self.out_nc
        self.G0 = CompositeGenerator(in_nc, prev_nc, self.out_nc, opt["ngf"],
                                     opt["n_downsample_G"], opt["n_blocks"])
        for s in range(1, self.n_scales):
            self.add_module(f"G{s}", CompositeLocalGenerator(
                in_nc, prev_nc, self.out_nc, opt["ngf"] // 2**s, opt["n_blocks_local"],
                opt["n_downsample_G"], s))
        self.eval()

    def set_fp8(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.fp8 = on

    def zero_state(self, batch: int, height: int, width: int, device) -> list:
        """The tG - 1 previous frames of each pyramid level, finest first,
        stacked on channels: zeros (a sequence's start without first
        frames)."""
        state = []
        for _ in range(self.n_scales):
            state.append(torch.zeros(batch, (self.tG - 1) * self.out_nc, height, width,
                                     device=device))
            height, width = (height + 1) // 2, (width + 1) // 2
        return state

    def encode(self, labels: torch.Tensor, inst: torch.Tensor) -> list:
        """(B, tG, H, W) labels and instance ids -> the window's pyramid,
        finest first: (B, tG * (label_nc + 1), H_l, W_l) each."""
        b, t, h, w = labels.shape
        enc = torch.cat([one_hot(labels, self.label_nc), instance_edges(inst).unsqueeze(2)], 2)
        levels = [enc.reshape(b * t, -1, h, w)]
        for _ in range(1, self.n_scales):
            levels.append(pool(levels[-1]))
        return [x.reshape(b, t, x.shape[1], x.shape[2], x.shape[3]) for x in levels]

    @torch.no_grad()
    def step(self, labels: torch.Tensor, inst: torch.Tensor, state: list):
        """One frame from a (B, tG, H, W) window and the state: (frame (B,
        3, H, W), new state)."""
        wins = self.encode(labels, inst)
        coarse, new_state = None, list(state)
        for s in range(self.n_scales):
            level = self.n_scales - 1 - s
            win = wins[level]
            mask = win[:, -1, self.fg_labels].sum(1, keepdim=True).clamp(0.0, 1.0)
            lab = win.reshape(win.shape[0], -1, win.shape[3], win.shape[4])
            coarse = getattr(self, f"G{s}")(lab, state[level], mask, coarse)
            new_state[level] = torch.cat([state[level][:, self.out_nc:], coarse[0]], 1)
        return coarse[0], new_state
