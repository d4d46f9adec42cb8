"""The composite (flow-warped) video generators — the core of vid2vid.

CompositeGenerator (coarsest scale, G0): two encoder trunks — one over the
stacked label maps, one over the stacked previous frames — are summed; an
image branch (resblocks, upsampling, tanh head) gives the hallucinated
"raw" frame; a flow branch gives the optical flow (x20) and a sigmoid
occlusion weight; the output frame is raw * w + warp(prev, flow) * (1 - w);
an optional foreground branch is alpha-composited by the fg mask.

CompositeLocalGenerator (finer scales, G1..): one-downsample trunks; the
coarser scale's features are added to the trunk output before the
residual and upsampling stages; the flow scales as 20 * 2**scale.

Module and Sequential names are the reference's (its networks.py), so a
published checkpoint loads with `load_state_dict`. Every branch runs its own
convolutions: the JAX package's TPU-only regrouping of branches into fused
block kernels (FusedConv7, _FusedResPair, ...) computes the same math and
has no counterpart here.

On a width shard (parallel/halo.py, set by the generator around a frame)
`prev_frames` stays the whole previous frames: the previous-frame trunk
takes this shard's columns of them, and the warp samples the whole frame
at the shard's column offset (`ops.warp_blend_at`, with its gradient), so
the flow needs no halo however far it reaches. The warp reads the whole
frame at a place of its own on every rank, so it reads it through
`halo.shared`, whose backward sums the gradient over the ranks (the
gradient invariant of parallel/halo.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from vid2vid_tpu_torch.nn.blocks import (
    ResnetBlock,
    conv_head,
    conv_stem,
    down_block,
    tanh_head,
    up_block,
)
from vid2vid_tpu_torch.ops.warp import warp_blend, warp_blend_at
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.utils.profiling import WARP_BLEND, span


def local_columns(prev_frames: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This shard's columns of the whole previous frames, at the level of
    `like` (prev_frames itself unsharded)."""
    shard = halo.active(like)
    return prev_frames if shard is None else shard.local(prev_frames)


class CompositeOut(NamedTuple):
    """Single-scale generator outputs, NCHW (None for disabled branches)."""

    img_final: torch.Tensor
    flow: torch.Tensor | None
    weight: torch.Tensor | None
    img_raw: torch.Tensor
    img_feat: torch.Tensor
    flow_feat: torch.Tensor | None
    fg_feat: torch.Tensor | None


def _trunk(cin: int, ngf: int, n_down: int, norm: str) -> list[nn.Module]:
    """Stem + n_down stride-2 blocks, doubling the width each time."""
    layers = conv_stem(cin, ngf, norm)
    for i in range(n_down):
        layers += down_block(ngf * 2**i, ngf * 2 ** (i + 1), norm)
    return layers


def _ups(ngf: int, n_up: int, norm: str) -> list[nn.Module]:
    """n_up upsampling blocks from ngf * 2**n_up down to ngf."""
    layers: list[nn.Module] = []
    for i in range(n_up):
        layers += up_block(ngf * 2 ** (n_up - i), ngf * 2 ** (n_up - 1 - i), norm)
    return layers


def _resblocks(dim: int, n: int, norm: str) -> list[nn.Module]:
    return [ResnetBlock(dim, norm) for _ in range(n)]


class _Heads(nn.Module):
    """The output heads and the compose step shared by both generators."""

    def _heads(self, ngf: int, ngf_i: int, output_nc: int) -> None:
        self.model_final_img = nn.Sequential(*tanh_head(ngf, output_nc))
        if not self.no_flow:
            self.model_final_flow = nn.Sequential(*conv_head(ngf, 2))
            self.model_final_w = nn.Sequential(*conv_head(ngf, 1, sigmoid=True))
        if self.use_fg:
            self.indv_final = nn.Sequential(*tanh_head(ngf_i, output_nc))

    def _compose(
        self, prev_frames, mask, use_raw_only, img_feat, flow_feat, fg_feat,
        flow_multiplier,
    ) -> CompositeOut:
        """Heads, then the temporal blend, then the fg alpha composite."""
        img_raw = self.model_final_img(img_feat)
        flow = weight = None
        if not self.no_flow:
            flow = self.model_final_flow(flow_feat) * flow_multiplier
            weight = self.model_final_w(flow_feat)
        if use_raw_only or self.no_flow:
            img_final = img_raw
        else:
            with span(WARP_BLEND):
                prev = prev_frames[:, -img_raw.shape[1]:].contiguous()
                shard = halo.active(img_raw)
                if shard is None:
                    img_final = warp_blend(img_raw, prev, flow.contiguous(), weight)
                else:
                    img_final = warp_blend_at(img_raw.contiguous(), halo.shared(prev, shard),
                                              flow.contiguous(), weight.contiguous(), shard.x0)
        if self.use_fg:
            img_fg = self.indv_final(fg_feat)
            img_final = img_fg * mask + img_final * (1.0 - mask)
            img_raw = img_fg * mask + img_raw * (1.0 - mask)
        return CompositeOut(
            img_final, flow, weight, img_raw, img_feat, flow_feat, fg_feat
        )


class CompositeGenerator(_Heads):
    """Full composite generator (coarsest scale, G0).

    `labels` is (B, input_nc, H, W) — tG encoded frames stacked time-major
    on channels; `prev_frames` is (B, prev_nc, H, W), the tG-1 previous
    output frames with the most recent last; `mask` is (B, 1, H, W).
    """

    def __init__(
        self,
        input_nc: int,
        prev_nc: int,
        output_nc: int = 3,
        ngf: int = 128,
        n_downsampling: int = 3,
        n_blocks: int = 9,
        norm: str = "batch",
        use_fg: bool = False,
        no_flow: bool = False,
    ):
        super().__init__()
        nd = n_downsampling
        n_res_down, n_res_up = n_blocks - n_blocks // 2, n_blocks // 2
        ngf_i = ngf // 2 if nd > 2 else ngf
        ch = ngf * 2**nd
        self.use_fg, self.no_flow = use_fg, no_flow

        self.model_down_seg = nn.Sequential(
            *_trunk(input_nc, ngf, nd, norm), *_resblocks(ch, n_res_down, norm)
        )
        self.model_down_img = nn.Sequential(
            *_trunk(prev_nc, ngf, nd, norm), *_resblocks(ch, n_res_down, norm)
        )
        self.model_res_img = nn.Sequential(*_resblocks(ch, n_res_up, norm))
        self.model_up_img = nn.Sequential(*_ups(ngf, nd, norm))
        if not no_flow:
            self.model_res_flow = nn.Sequential(*_resblocks(ch, n_res_up, norm))
            self.model_up_flow = nn.Sequential(*_ups(ngf, nd, norm))
        if use_fg:
            self.indv_down = nn.Sequential(*_trunk(input_nc, ngf_i, nd, norm))
            self.indv_res = nn.Sequential(
                *_resblocks(ngf_i * 2**nd, n_blocks, norm)
            )
            self.indv_up = nn.Sequential(*_ups(ngf_i, nd, norm))
        self._heads(ngf, ngf_i, output_nc)

    def forward(
        self,
        labels: torch.Tensor,
        prev_frames: torch.Tensor,
        mask: torch.Tensor | None = None,
        use_raw_only: bool = False,
    ) -> CompositeOut:
        d = (self.model_down_seg(labels)
             + self.model_down_img(local_columns(prev_frames, labels)))
        img_feat = self.model_up_img(self.model_res_img(d))
        flow_feat = None
        if not self.no_flow:
            flow_feat = self.model_up_flow(self.model_res_flow(d))
        fg_feat = None
        if self.use_fg:
            fg_feat = self.indv_up(self.indv_res(self.indv_down(labels)))
        return self._compose(
            prev_frames, mask, use_raw_only, img_feat, flow_feat, fg_feat, 20.0
        )


class CompositeLocalGenerator(_Heads):
    """Enhancer scale (G1..): refines the coarser scale at twice the size.

    `coarse` is the coarser scale's CompositeOut; its img/flow/fg features
    are added to this scale's trunk outputs.
    """

    def __init__(
        self,
        input_nc: int,
        prev_nc: int,
        output_nc: int = 3,
        ngf: int = 64,
        n_blocks_local: int = 3,
        n_downsample_g: int = 3,
        scale: int = 1,
        norm: str = "batch",
        use_fg: bool = False,
        no_flow: bool = False,
    ):
        super().__init__()
        ngf_i = ngf // 2 if n_downsample_g > 2 else ngf
        self.use_fg, self.no_flow, self.scale = use_fg, no_flow, scale
        nbl = n_blocks_local

        def up_stack(width):
            return nn.Sequential(
                *_resblocks(2 * width, nbl, norm), *_ups(width, 1, norm)
            )

        self.model_down_seg = nn.Sequential(*_trunk(input_nc, ngf, 1, norm))
        self.model_down_img = nn.Sequential(*_trunk(prev_nc, ngf, 1, norm))
        self.model_up_img = up_stack(ngf)
        if not no_flow:
            self.model_up_flow = up_stack(ngf)
        if use_fg:
            self.indv_down = nn.Sequential(*_trunk(input_nc, ngf_i, 1, norm))
            self.indv_up = up_stack(ngf_i)
        self._heads(ngf, ngf_i, output_nc)

    def forward(
        self,
        labels: torch.Tensor,
        prev_frames: torch.Tensor,
        coarse: CompositeOut,
        mask: torch.Tensor | None = None,
        use_raw_only: bool = False,
    ) -> CompositeOut:
        d = (self.model_down_seg(labels)
             + self.model_down_img(local_columns(prev_frames, labels)))
        img_feat = self.model_up_img(d + coarse.img_feat)
        flow_feat = None
        if not self.no_flow:
            flow_feat = self.model_up_flow(d + coarse.flow_feat)
        fg_feat = None
        if self.use_fg:
            fg_feat = self.indv_up(self.indv_down(labels) + coarse.fg_feat)
        return self._compose(
            prev_frames, mask, use_raw_only, img_feat, flow_feat, fg_feat,
            20.0 * 2**self.scale,
        )
