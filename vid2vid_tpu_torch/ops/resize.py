"""Image resizing helpers (the port of vid2vid_tpu/ops/resize.py), NCHW.

The FlowNet wrapper resizes inputs to a multiple of 64 with the reference's
`nn.Upsample(mode='bilinear')` under PyTorch 0.4, whose default is
align_corners=False (half-pixel centres); without antialiasing it is a pure
2-tap sample even when it downscales, as jax.image.resize(..., "linear",
antialias=False) is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of an NCHW batch to (height, width), half-pixel
    centres, no antialiasing."""
    return F.interpolate(
        x, size=(height, width), mode="bilinear", align_corners=False,
        antialias=False,
    )


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
