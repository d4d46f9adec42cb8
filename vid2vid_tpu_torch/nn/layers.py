"""Layer primitives with the reference's numerics, as torch.nn modules.

The reference builds its networks as `nn.Sequential` stacks whose indices
are the state-dict names of the published checkpoints
(`model_down_seg.1.weight`, ...), so the helpers here return flat layer
lists that callers splice into their Sequentials, padding layers included.

  - reflect_conv: ReflectionPad2d(k // 2) + Conv2d(k) — two list entries;
    reflect_conv7 the same 7x7 pair, run in eval mode as one conv7 op
    (the hand-written kernel on the card) with the pad folded in.
  - conv_transpose: ConvTranspose2d(3, 2, padding=1, output_padding=1).
  - norm_layer('batch'): BatchNorm2d; eval mode normalizes with the
    running stats.
  - norm_layer('instance'): InstanceNorm2d(affine=False,
    track_running_stats=True); eval mode also uses the running stats (the
    behaviour the reference's single-image checkpoints depend on).
  - norm_layer('none'): Identity, which keeps the Sequential's indices.

Train mode normalizes with the batch's (instance norm: each sample's)
statistics and updates the running stats as torch.nn's norms do (momentum
0.1, unbiased variance), as the JAX norms do under mutable batch_stats. The
JAX package's training steps never update them (its loss engine and
train_cli say why): `update_running_stats(module, False)` turns the update
off on every norm of a module, which the port's Trainer does for the
generator and the discriminators.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vid2vid_tpu_torch.ops.conv7 import conv7_reflect


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode leaves the running stats alone while
    `update_stats` is False."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.update_stats:
            return super().forward(x)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class InstanceNorm2d(nn.InstanceNorm2d):
    """nn.InstanceNorm2d(track_running_stats=True) whose train mode leaves
    the running stats alone while `update_stats` is False."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.update_stats:
            return super().forward(x)
        return F.instance_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def update_running_stats(module: nn.Module, on: bool) -> list[nn.Module]:
    """Turn the train-mode running-stat update of every norm in `module` on
    or off; returns those norms."""
    norms = [m for m in module.modules() if isinstance(m, (BatchNorm2d, InstanceNorm2d))]
    for m in norms:
        m.update_stats = on
    return norms


def reflect_conv(cin: int, cout: int, kernel: int) -> list[nn.Module]:
    """ReflectionPad2d(kernel // 2) + Conv2d(cin, cout, kernel)."""
    return [nn.ReflectionPad2d(kernel // 2), nn.Conv2d(cin, cout, kernel)]


class FoldedReflectionPad2d(nn.ReflectionPad2d):
    """ReflectionPad2d(3) ahead of a `ReflectConv7`: it pads in train mode
    and passes its input through in eval mode, where the conv folds the
    reflection into its kernel's load addressing."""

    def __init__(self):
        super().__init__(3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) if self.training else x


class ReflectConv7(nn.Conv2d):
    """Conv2d(cin, cout, 7) behind a `FoldedReflectionPad2d`. Train mode is
    the plain conv of the padded input; eval mode runs ops.conv7.
    conv7_reflect on the unpadded input: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU one."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        return conv7_reflect(x.contiguous(), self.weight.to(x.dtype), self.bias.float())


def reflect_conv7(cin: int, cout: int) -> list[nn.Module]:
    """`reflect_conv(cin, cout, 7)` through the conv7 kernel in eval mode:
    the same two Sequential entries, so the same state-dict names."""
    return [FoldedReflectionPad2d(), ReflectConv7(cin, cout)]


def conv_transpose(cin: int, cout: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(3, stride 2, padding 1, output_padding 1): 2x H, W."""
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)


def norm_layer(kind: str, channels: int) -> nn.Module:
    """The reference's get_norm_layer: batch, instance or none."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "instance":
        return InstanceNorm2d(channels, affine=False, track_running_stats=True)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm kind {kind!r}")


def eval_affine(
    norm: nn.Module, channels: int, device: torch.device | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode norm as a per-channel affine y = x * a + c, in float32.

    batch: a = weight / sqrt(var + eps), c = bias - mean * a;
    instance (running stats): a = 1 / sqrt(var + eps), c = -mean * a;
    none: a = 1, c = 0 (on `device`) — as the JAX norms' `want_affine`
    gives them.
    """
    if isinstance(norm, nn.Identity):
        return torch.ones(channels, device=device), torch.zeros(channels, device=device)
    if not isinstance(norm, (nn.BatchNorm2d, nn.InstanceNorm2d)) or (
        norm.running_var is None
    ):
        raise TypeError(f"eval_affine: {type(norm).__name__} has no running stats")
    a = torch.rsqrt(norm.running_var.float() + norm.eps)
    if norm.affine:
        a = norm.weight.float() * a
        return a, norm.bias.float() - norm.running_mean.float() * a
    return a, -norm.running_mean.float() * a


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's weights_init from a seeded generator: conv weights
    N(0, 0.02), norm scales N(1, 0.02), biases zero."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator) * 0.02
                )
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(
                    1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator)
                )
                m.bias.zero_()
