"""The repeated motifs of the reference's Sequential stacks.

`conv_stem`, `down_block`, `up_block`, `tanh_head` and `conv_head` return
flat layer lists (the JAX package's ConvStem, DownBlock, UpBlock, TanhHead
and ConvHead modules): the reference splices them into one Sequential per
trunk, and its indices are the checkpoint's names. `ResnetBlock` is a
module, as in the reference, with its `conv_block` Sequential. The
composite generators keep their 7x7 stems and heads on cuDNN; the
single-image nets (nn/pix2pixhd.py) pass `conv7=True`.
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.nn.layers import (
    conv_transpose,
    eval_affine,
    norm_layer,
    reflect_conv,
    reflect_conv7,
)
from vid2vid_tpu_torch.ops.respair import respair


def _conv7(cin: int, cout: int, kernel: bool) -> list[nn.Module]:
    return reflect_conv7(cin, cout) if kernel else reflect_conv(cin, cout, 7)


def conv_stem(cin: int, cout: int, norm: str, conv7: bool = False) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 + norm + ReLU (4 entries); `conv7` runs
    the 7x7 conv through the conv7 kernel in eval mode (reflect_conv7)."""
    return [*_conv7(cin, cout, conv7), norm_layer(norm, cout), nn.ReLU(True)]


def down_block(cin: int, cout: int, norm: str) -> list[nn.Module]:
    """Conv3x3 stride 2, zero padding 1, + norm + ReLU (3 entries)."""
    return [nn.Conv2d(cin, cout, 3, stride=2, padding=1), norm_layer(norm, cout),
            nn.ReLU(True)]


def up_block(cin: int, cout: int, norm: str) -> list[nn.Module]:
    """ConvTranspose(3, s2, p1, op1) + norm + ReLU (3 entries)."""
    return [conv_transpose(cin, cout), norm_layer(norm, cout), nn.ReLU(True)]


def tanh_head(cin: int, cout: int, conv7: bool = False) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 + tanh (3 entries); `conv7` as in
    conv_stem."""
    return [*_conv7(cin, cout, conv7), nn.Tanh()]


def conv_head(cin: int, cout: int, sigmoid: bool = False) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 [+ sigmoid] (the flow and weight heads)."""
    return [*reflect_conv(cin, cout, 7)] + ([nn.Sigmoid()] if sigmoid else [])


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 residual block: x + norm(conv(relu(norm(conv(x))))).

    Training runs the plain layers. Eval folds each conv bias and eval-mode
    norm into one affine (a, c + bias * a) and runs the whole block as one
    `ops.respair` — the CUDA kernel on a CUDA tensor, for any width.
    """

    def __init__(self, dim: int, norm: str = "batch"):
        super().__init__()
        self.dim = dim
        self.conv_block = nn.Sequential(
            *reflect_conv(dim, dim, 3), norm_layer(norm, dim), nn.ReLU(True),
            *reflect_conv(dim, dim, 3), norm_layer(norm, dim),
        )

    def _folded(self, conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor):
        a, c = eval_affine(norm, self.dim, x.device)
        return conv.weight.to(x.dtype), (a, c + conv.bias.float() * a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return x + self.conv_block(x)
        blk = self.conv_block
        k0, ab0 = self._folded(blk[1], blk[2], x)
        k1, ab1 = self._folded(blk[5], blk[6], x)
        return respair(x.contiguous(), k0, ab0, k1, ab1)
