"""Pooling and pyramids (NCHW).

The reference builds its spatial pyramids with
`AvgPool2d(3, stride=2, padding=1, count_include_pad=False)`: border windows
divide by the number of valid taps. The discriminators pool between their
scales with the same 3x3/s2 average.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, stride=2): the VGG loss's downsampler for inputs wider
    than its limit (vid2vid_tpu/losses.py)."""
    return F.avg_pool2d(x, 2, 2)


def build_pyramid(x: torch.Tensor, n_scales: int) -> list[torch.Tensor]:
    """[finest, ..., coarsest] by repeated 3x3/s2 averaging of (N, C, H, W)."""
    pyr = [x]
    for _ in range(1, n_scales):
        pyr.append(avg_pool_3x3s2(pyr[-1]))
    return pyr


def build_pyramid_video(x: torch.Tensor, n_scales: int) -> list[torch.Tensor]:
    """Pyramid of a (B, T, C, H, W) clip, pooling each frame; finest first."""
    b, t = x.shape[:2]
    pyr = build_pyramid(x.reshape((b * t,) + x.shape[2:]), n_scales)
    return [p.reshape((b, t) + p.shape[1:]) for p in pyr]
