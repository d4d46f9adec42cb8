"""Flow losses (the port of vid2vid_tpu/models/flownet2/losses.py;
reference: models/flownet2_pytorch/losses.py), NCHW, channel 0 = x.

EPE (end-point error), L1 / L2 norms and the multiscale pyramid loss used to
train the component flow nets. The eval path uses `epe`; the flow-net
training harness (`harness.FlowHarness.train_step`) uses
`multiscale_flow_loss`.
"""

from __future__ import annotations

import torch

from vid2vid_tpu_torch.ops.resize import resize_bilinear


def epe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean end-point error: mean ||pred - target||_2 over pixels."""
    return torch.linalg.vector_norm(pred - target, dim=1).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pred - target, dim=1).mean()


_MULTISCALE_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32)


def multiscale_flow_loss(
    flow_pyramid: tuple[torch.Tensor, ...],
    target: torch.Tensor,
    div_flow: float = 0.05,
    norm: str = "L1",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted pyramid loss over the five decoder flows (finest first).

    Returns (loss, epe at the finest level). The target is resized to each
    level; the weights are the reference's [0.005, 0.01, 0.02, 0.08, 0.32].
    """
    target = div_flow * target
    norm_fn = l1_loss if norm == "L1" else l2_loss
    loss = target.new_zeros(())
    for w, flow in zip(_MULTISCALE_WEIGHTS, flow_pyramid):
        t = resize_bilinear(target, flow.shape[-2], flow.shape[-1])
        loss = loss + w * norm_fn(flow, t)
    finest_up = resize_bilinear(flow_pyramid[0], target.shape[-2], target.shape[-1])
    return loss, epe(finest_up / div_flow, target / div_flow)
