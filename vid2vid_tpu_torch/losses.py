"""Loss functions (reference: models/networks.py:731-837), NCHW.

The port of vid2vid_tpu/losses.py's training losses. The reference's
GANLoss quirk is kept: `opt.gan_mode` is passed where a bool is expected,
so every advertised mode resolves to LSGAN (reference:
models/vid2vid_model_D.py:62, networks.py:740); 'ls' is the default here
and 'original' (BCE with logits) and 'hinge' are the JAX package's opt-ins.

On the model axis each rank holds its columns of the frames, the patch maps
and the features, and its loss is its share of the whole frame's: each
mean is the sum of the rank's elements over the whole tensor's count
(`share_mean`, the whole width given: `widths` / `total`), so the ranks'
losses sum to the whole loss and each back-propagates through its own
elements, with no collective.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.ops.pool import avg_pool_2x2

DiscOut = Sequence[Sequence[torch.Tensor]]  # per-scale lists of activations


def share_mean(x: torch.Tensor, total: int | None = None) -> torch.Tensor:
    """torch.mean(x); with `total`, x this rank's columns of a tensor
    `total` wide (the model axis), this rank's share of the whole tensor's
    mean: the sum of its elements over the whole tensor's count."""
    if total is None:
        return torch.mean(x)
    return x.sum() / (math.prod(x.shape[:-1]) * total)


def _per_pred(pred: DiscOut, fn, widths=None) -> torch.Tensor:
    """Sum fn(patch_map, its whole width or None) over the multiscale
    prediction list."""
    total = 0.0
    for i, scale_feats in enumerate(pred):
        total = total + fn(scale_feats[-1], None if widths is None else widths[i][-1])
    return total


def gan_loss(
    pred: DiscOut, target_is_real: bool, mode: str = "ls",
    for_discriminator: bool = True, widths=None,
) -> torch.Tensor:
    """Multiscale GAN loss on the final patch maps (with `widths`, the
    discriminator's whole output widths, MultiscaleDiscriminator.widths:
    the model axis's share of it).

    'ls': MSE against 1/0 (the reference's effective behaviour);
    'original': BCE with logits; 'hinge': the standard hinge.
    """
    target = 1.0 if target_is_real else 0.0
    if mode == "ls":
        return _per_pred(pred, lambda p, w: share_mean((p - target) ** 2, w), widths)
    if mode == "original":
        return _per_pred(
            pred,
            lambda p, w: share_mean(F.relu(p) - p * target + torch.log1p(torch.exp(-p.abs())),
                                    w),
            widths,
        )
    if mode == "hinge":
        if not for_discriminator:
            return _per_pred(pred, lambda p, w: -share_mean(p, w), widths)
        sign = -1.0 if target_is_real else 1.0
        return _per_pred(pred, lambda p, w: share_mean(F.relu(1.0 + sign * p), w), widths)
    raise ValueError(f"unknown gan mode {mode!r}")


def feature_matching_loss(
    pred_fake: DiscOut, pred_real: DiscOut, num_d: int, n_layers_d: int,
    lambda_feat: float, widths=None,
) -> torch.Tensor:
    """L1 between fake and (detached) real D activations, weighted
    4/(n_layers+1) per layer and 1/num_D per scale (reference:
    models/vid2vid_model_D.py:199-213); with `widths`, the model axis's
    share of it."""
    feat_w = 4.0 / (n_layers_d + 1)
    d_w = 1.0 / num_d
    loss = 0.0
    for i in range(min(len(pred_fake), num_d)):
        for j in range(len(pred_fake[i]) - 1):
            loss = loss + d_w * feat_w * lambda_feat * share_mean(
                (pred_fake[i][j] - pred_real[i][j].detach()).abs(),
                None if widths is None else widths[i][j],
            )
    return loss


def masked_l1(input: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              total: int | None = None) -> torch.Tensor:
    """mean(|input * mask - target * mask|), the mask broadcast over
    channels (with `total`, the frames' whole width: the model axis's
    share of it)."""
    return share_mean((input * mask - target * mask).abs(), total)


_VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss(
    vgg: Callable[..., list[torch.Tensor]],
    x: torch.Tensor, y: torch.Tensor, max_width: int = 1024, shard=None,
) -> torch.Tensor:
    """VGG19 perceptual loss with the reference's tap weights; inputs wider
    than `max_width` are 2x average-pooled first (reference:
    models/networks.py:784-786). With `shard` (a parallel/halo.py::
    WidthShard: x and y its columns of frames shard.total wide) VGG runs on
    the rank's columns, the width test reads the whole frame's width and
    the loss is the rank's share."""
    if shard is None:
        while x.shape[-1] > max_width:
            x, y = avg_pool_2x2(x), avg_pool_2x2(y)
        fx, fy, widths = vgg(x), vgg(y), [None] * len(_VGG_SLICE_WEIGHTS)
    else:
        while shard.total > max_width:
            x, y = avg_pool_2x2(x, shard), avg_pool_2x2(y, shard)
            shard = shard.of_width(shard.total // 2)
        fx, fy, widths = vgg(x, shard), vgg(y, shard), vgg.tap_widths(shard.total)
    loss = 0.0
    for w, a, b, total in zip(_VGG_SLICE_WEIGHTS, fx, fy, widths):
        loss = loss + w * share_mean((a - b.detach()).abs(), total)
    return loss
