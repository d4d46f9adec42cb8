"""Per-pixel L2 norm across channels (the FlowNet2 ChannelNorm op), NCHW.

out[b, 0, y, x] = sqrt(sum_c x[b, c, y, x]^2) (reference channelnorm_kernel.cu:
18-60; the port of vid2vid_tpu/ops/channelnorm.py). A plain torch op: it is
not a TPU kernel.
"""

from __future__ import annotations

import torch


def channel_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """sqrt(sum(x^2, dim=1)) over the channel axis of an NCHW tensor."""
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=keepdim))
