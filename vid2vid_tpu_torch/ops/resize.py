"""Image resizing helpers (the port of vid2vid_tpu/ops/resize.py), NCHW.

The FlowNet wrapper resizes inputs to a multiple of 64 with the reference's
`nn.Upsample(mode='bilinear')` under PyTorch 0.4, whose default is
align_corners=False (half-pixel centres); without antialiasing it is a pure
2-tap sample even when it downscales, as jax.image.resize(..., "linear",
antialias=False) is.

On training's model axis (parallel/halo.py) a resize also runs on a width
shard: x is this rank's columns of a tensor shard.total wide, and the
result its columns of the whole resize, split by the same rule
(`WidthShard.of_width`). The source columns they sample are fetched from
the ranks that own them (kind "resize") and sampled at their global
coordinates (`halo.resize_taps`, PyTorch's float32 arithmetic): an
F.interpolate of the local columns would sample them right only at an
integer factor whose split lines up.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.parallel import halo


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    shard: halo.WidthShard | None = None) -> torch.Tensor:
    """Bilinear resize of an NCHW batch to (height, width), half-pixel
    centres, no antialiasing; on a shard, this rank's columns of it
    (`resize_columns`)."""
    if shard is not None:
        return resize_columns(x, height, width, shard, "linear")
    return F.interpolate(
        x, size=(height, width), mode="bilinear", align_corners=False,
        antialias=False,
    )


def resize_nearest(x: torch.Tensor, height: int, width: int,
                   shard: halo.WidthShard | None = None) -> torch.Tensor:
    """Nearest resize of an NCHW batch to (height, width) (PyTorch's
    "nearest": source floor(d in / out)); on a shard, this rank's columns
    of it (`resize_columns`)."""
    if shard is not None:
        return resize_columns(x, height, width, shard, "nearest")
    return F.interpolate(x, size=(height, width), mode="nearest")


@functools.lru_cache(maxsize=256)
def _taps(n_in: int, n_out: int, a: int, b: int, mode: str, device: torch.device):
    """halo.resize_taps as tensors on `device` (kept)."""
    first, frac = halo.resize_taps(n_in, n_out, a, b, mode)
    return (torch.from_numpy(first).to(device), torch.from_numpy(frac).to(device))


def resize_columns(x: torch.Tensor, height: int, width: int, shard: halo.WidthShard,
                   mode: str) -> torch.Tensor:
    """This rank's columns of the resize of a width-sharded tensor to
    (height, width), x its columns of a tensor shard.total wide: the source
    columns fetched (one exchange where a rank samples another's), then
    each output pixel from its source rows r0, r0 + 1 and columns c0,
    c0 + 1 (`halo.resize_taps`) as aten's bilinear kernel combines them,
    (1 - fy) ((1 - fx) x[r0, c0] + fx x[r0, c1]) + fy ((1 - fx) x[r1, c0]
    + fx x[r1, c1]); "nearest" reads x[r0, c0]."""
    out = shard.of_width(width)
    src = halo.fetch(x, shard, ("resize", width, mode))
    if not out.width:
        return x.new_zeros(x.shape[:-2] + (height, 0))
    c0, fx = _taps(shard.total, width, out.x0, out.x1, mode, x.device)
    r0, fy = _taps(x.shape[-2], height, 0, height, mode, x.device)
    c0 = c0 - c0[0]  # the fetched columns start at the first source column
    if mode == "nearest":
        return src.index_select(-1, c0).index_select(-2, r0)
    fx, fy = fx.to(x.dtype), fy.to(x.dtype)
    r1 = torch.clamp(r0 + 1, max=x.shape[-2] - 1)
    cols = (1 - fx) * src.index_select(-1, c0) + fx * src.index_select(-1, c0 + 1)
    fy = fy[:, None]
    return (1 - fy) * cols.index_select(-2, r0) + fy * cols.index_select(-2, r1)


def make_divisible(size: int, base: int) -> int:
    """Largest multiple of `base` that is <= size (the reference's //base*base)."""
    return size // base * base


def scale_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize a (B, 2, H, W) flow field and rescale its magnitudes.

    The reference rescales both axes by the height ratio only (reference:
    models/flownet.py:57); so does this.
    """
    old_h = flow.shape[-2]
    return resize_bilinear(flow, height, width) * (height / old_h)
