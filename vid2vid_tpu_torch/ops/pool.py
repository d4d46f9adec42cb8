"""Pooling and pyramids (NCHW).

The reference builds its spatial pyramids with
`AvgPool2d(3, stride=2, padding=1, count_include_pad=False)`: border windows
divide by the number of valid taps. The discriminators pool between their
scales with the same 3x3/s2 average.

On the model axis (a tensor's columns split over ranks: parallel/halo.py)
the pools take a `shard`, this rank's columns of x: each fetches the
columns its output columns read (`halo.window`) and returns its columns of
the pooled tensor, split by the same rule. The 3x3/s2 pool's divisor
counts the taps inside the image by their global column, so an edge
window divides as the whole tensor's does and an inner one by 9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.parallel import halo


def _taps(n_out: int, n_in: int, first: int, device) -> torch.Tensor:
    """How many of each 3x3/s2 window's three taps along one axis (output
    positions first .. first + n_out - 1 of an axis n_in long, padding 1)
    lie inside it."""
    o = torch.arange(first, first + n_out, device=device)
    return ((2 * o - 1).clamp(0, n_in) - (2 * o + 2).clamp(0, n_in)).neg().float()


def avg_pool_3x3s2(x: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False); with a
    `shard` (x this rank's columns of a tensor shard.total wide), this
    rank's columns of the pooled tensor ((total - 1) // 2 + 1 wide): the
    window sums of the fetched columns divided by the taps inside the image
    (rows by their row, columns by their global column)."""
    if shard is None:
        return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
    xf, out = halo.window(x, shard, 3, 2, 1)
    sums = halo.valid_conv(lambda t: F.avg_pool2d(t, 3, 2, (1, 0), divisor_override=1), xf, 3)
    rows = _taps(sums.shape[-2], x.shape[-2], 0, x.device)
    cols = _taps(out.width, shard.total, out.x0, x.device)
    return sums / (rows[:, None] * cols[None, :]).to(sums.dtype)


def avg_pool_2x2(x: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
    """AvgPool2d(2, stride=2): the VGG loss's downsampler for inputs wider
    than its limit (vid2vid_tpu/losses.py); with a `shard`, this rank's
    columns of the pooled tensor (total // 2 wide)."""
    if shard is None:
        return F.avg_pool2d(x, 2, 2)
    xf, _ = halo.window(x, shard, 2, 2, 0)
    return halo.valid_conv(lambda t: F.avg_pool2d(t, 2, 2), xf, 2)


def max_pool_2x2(x: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
    """MaxPool2d(2, 2) (VGG's); with a `shard`, this rank's columns of the
    pooled tensor (total // 2 wide)."""
    if shard is None:
        return F.max_pool2d(x, 2, 2)
    xf, _ = halo.window(x, shard, 2, 2, 0)
    return halo.valid_conv(lambda t: F.max_pool2d(t, 2, 2), xf, 2)


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
