"""Loss functions (reference: models/networks.py:731-837), NCHW.

The port of vid2vid_tpu/losses.py's training losses. The reference's
GANLoss quirk is kept: `opt.gan_mode` is passed where a bool is expected,
so every advertised mode resolves to LSGAN (reference:
models/vid2vid_model_D.py:62, networks.py:740); 'ls' is the default here
and 'original' (BCE with logits) and 'hinge' are the JAX package's opt-ins.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.ops.pool import avg_pool_2x2

DiscOut = Sequence[Sequence[torch.Tensor]]  # per-scale lists of activations


def _per_pred(pred: DiscOut, fn) -> torch.Tensor:
    """Sum fn(patch_map) over the multiscale prediction list."""
    total = 0.0
    for scale_feats in pred:
        total = total + fn(scale_feats[-1])
    return total


def gan_loss(
    pred: DiscOut, target_is_real: bool, mode: str = "ls",
    for_discriminator: bool = True,
) -> torch.Tensor:
    """Multiscale GAN loss on the final patch maps.

    'ls': MSE against 1/0 (the reference's effective behaviour);
    'original': BCE with logits; 'hinge': the standard hinge.
    """
    target = 1.0 if target_is_real else 0.0
    if mode == "ls":
        return _per_pred(pred, lambda p: torch.mean((p - target) ** 2))
    if mode == "original":
        return _per_pred(
            pred,
            lambda p: torch.mean(F.relu(p) - p * target + torch.log1p(torch.exp(-p.abs()))),
        )
    if mode == "hinge":
        if not for_discriminator:
            return _per_pred(pred, lambda p: -torch.mean(p))
        sign = -1.0 if target_is_real else 1.0
        return _per_pred(pred, lambda p: torch.mean(F.relu(1.0 + sign * p)))
    raise ValueError(f"unknown gan mode {mode!r}")


def feature_matching_loss(
    pred_fake: DiscOut, pred_real: DiscOut, num_d: int, n_layers_d: int,
    lambda_feat: float,
) -> torch.Tensor:
    """L1 between fake and (detached) real D activations, weighted
    4/(n_layers+1) per layer and 1/num_D per scale (reference:
    models/vid2vid_model_D.py:199-213)."""
    feat_w = 4.0 / (n_layers_d + 1)
    d_w = 1.0 / num_d
    loss = 0.0
    for i in range(min(len(pred_fake), num_d)):
        for j in range(len(pred_fake[i]) - 1):
            loss = loss + d_w * feat_w * lambda_feat * torch.mean(
                (pred_fake[i][j] - pred_real[i][j].detach()).abs()
            )
    return loss


def masked_l1(input: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean(|input * mask - target * mask|), the mask broadcast over channels."""
    return torch.mean((input * mask - target * mask).abs())


_VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(
    vgg: Callable[[torch.Tensor], list[torch.Tensor]],
    x: torch.Tensor, y: torch.Tensor, max_width: int = 1024,
) -> torch.Tensor:
    """VGG19 perceptual loss with the reference's tap weights; inputs wider
    than `max_width` are 2x average-pooled first (reference:
    models/networks.py:784-786)."""
    while x.shape[-1] > max_width:
        x, y = avg_pool_2x2(x), avg_pool_2x2(y)
    fx, fy = vgg(x), vgg(y)
    loss = 0.0
    for w, a, b in zip(_VGG_SLICE_WEIGHTS, fx, fy):
        loss = loss + w * torch.mean((a - b.detach()).abs())
    return loss
