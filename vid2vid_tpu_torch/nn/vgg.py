"""VGG19 feature taps for the perceptual loss (NCHW).

Reference (models/networks.py:840-870): a frozen torchvision VGG19, tapped
after relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1. `features` holds
torchvision's first 30 layers under its own indices (`features.{i}`), so a
torchvision state_dict loads with `load_state_dict(strict=False)` and the
JAX package's VGG carries across with utils/from_jax.py. The inputs are
the generator's [-1, 1] frames, without ImageNet renormalisation, as the
reference feeds them.

On the model axis (`forward(x, shard)`, parallel/halo.py) it runs on the
rank's columns: each 3x3 conv fetches the columns its output columns read
(nn/layers.py::ShardConv2d, zero padding 1) and each 2x2 max pool the
pairs its output columns take (nn/layers.py::run_sharded); every tap is
the rank's columns of the whole one (`tap_widths` wide).
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.nn.layers import ShardConv2d, run_sharded
from vid2vid_tpu_torch.parallel import halo

# torchvision's vgg19 configuration 'E' up to conv5_1: widths, 'M' = 2x2 max pool
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512)
# end (exclusive) of each tap's slice of `features`: relu1_1 ... relu5_1
_CUTS = (2, 7, 12, 21, 30)


class Vgg19Features(nn.Module):
    """Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]; frozen."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [ShardConv2d(in_ch, v, 3, padding=1), nn.ReLU(True)]
                in_ch = v
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                shard: halo.WidthShard | None = None) -> list[torch.Tensor]:
        """With `shard` (x this rank's columns of frames shard.total wide)
        each tap is this rank's columns of the whole one."""
        taps, start = [], 0
        for cut in _CUTS:
            x, shard = run_sharded(self.features[start:cut], x, shard)
            taps.append(x)
            start = cut
        return taps

    def tap_widths(self, width: int) -> list[int]:
        """The whole widths of forward's taps for an input `width` wide
        (each 2x2 max pool floors it by half)."""
        widths, start = [], 0
        for cut in _CUTS:
            pools = sum(isinstance(m, nn.MaxPool2d) for m in self.features[start:cut])
            width >>= pools
            widths.append(width)
            start = cut
        return widths
