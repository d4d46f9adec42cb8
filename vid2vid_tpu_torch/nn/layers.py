"""Layer primitives with the reference's numerics, as torch.nn modules.

The reference builds its networks as `nn.Sequential` stacks whose indices
are the state-dict names of the published checkpoints
(`model_down_seg.1.weight`, ...), so the helpers here return flat layer
lists that callers splice into their Sequentials, padding layers included.

  - reflect_conv: ReflectionPad2d(k // 2) + Conv2d(k) — two list entries;
    reflect_conv7 the same 7x7 pair, run in eval mode as one conv7 op
    (the hand-written kernel on the card) with the pad folded in, its
    kernel arguments kept between calls (`version_key`).
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

from vid2vid_tpu_torch.ops.conv7 import TENSOR_CORES, conv7_body, conv7_reflect, pack_for_kernel


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


def version_key(tensors) -> list:
    """The key of a cache of values derived from `tensors`: each one's
    version counter (bumped by every in-place change: `copy_`,
    `load_state_dict`, an optimizer step), storage, dtype and device (a
    `.to()` gives new storage), flat."""
    key = []
    for t in tensors:
        key += (t._version, t.data_ptr(), t.dtype, t.device)
    return key


def eval_cached(module: nn.Module, x: torch.Tensor, tensors, build) -> tuple:
    """`build(x)`, kept in `module._eval_cache` and made anew only when the
    key (x's dtype and device, `version_key` of `tensors()`) changes. Under
    `torch.export` the cache is read as it stands, without its key's
    storage pointers, which traced tensors do not have: its derived tensors
    (folded affines, packed weights) enter the exported graph as constants,
    so the graph never rebuilds them, while an entry that is one of the
    module's own parameters (a weight already in x's dtype) is read from
    the module, so that the graph takes it as its parameter and stores no
    second copy. An eager call with x's dtype and device must have filled
    the cache (tools/export.py makes one); otherwise this raises."""
    if torch.compiler.is_exporting():
        cache = module._eval_cache
        if cache is None or cache[0][:2] != [x.dtype, x.device]:
            raise RuntimeError(f"{type(module).__name__}: no eval cache for {x.dtype} on "
                               f"{x.device}; run the module once eagerly before export")
        params = dict(module.named_parameters())
        return tuple(params[cache[2][i]] if i in cache[2] else v
                     for i, v in enumerate(cache[1]))
    key = [x.dtype, x.device, *version_key(tensors())]
    if module._eval_cache is None or module._eval_cache[0] != key:
        args = build(x)
        own = {i: name for i, v in enumerate(args) for name, p in module.named_parameters()
               if v is p}
        module._eval_cache = (key, args, own)
    return module._eval_cache[1]


def state_tensors(module: nn.Module, out: list | None = None) -> list:
    """Every parameter and buffer of `module` and its submodules, as they
    are now: a walk of the module tree, several times cheaper than
    `parameters()` + `buffers()`, which also build and deduplicate names."""
    out = [] if out is None else out
    for group in (module._parameters, module._buffers):
        for t in group.values():
            if t is not None:
                out.append(t)
    for child in module._modules.values():
        if child is not None:
            state_tensors(child, out)
    return out


def packs_on(x: torch.Tensor) -> bool:
    """Whether an eval cache may keep, for input x, the packed weights of
    the tensor-core conv body (ops/conv7.py::pack_for_kernel): on the card,
    where the kernels take them (the 7x7 where ops/conv7.py::conv7_body
    picks that body); the plain versions on the CPU do not."""
    return x.is_cuda


class ReflectConv7(nn.Conv2d):
    """Conv2d(cin, cout, 7) behind a `FoldedReflectionPad2d`. Train mode is
    the plain conv of the padded input; eval mode runs ops.conv7.
    conv7_reflect on the unpadded input: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU one. Under `torch.no_grad()` its
    kernel arguments (the weight in x's dtype, the f32 bias and, on the
    card where `conv7_body` picks the tensor cores, their packed weight:
    bf16, or f32 as 3xTF32) are kept and rebuilt only when the weight or
    bias changes (`version_key`) or x's dtype or device does
    (`eval_cached`); with gradients on they are made on each call, so the
    weights keep their gradient."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 7)
        # (key, conv7_reflect's weight args, {arg index: own parameter's name})
        self._eval_cache: tuple | None = None

    def _kernel_args(self, x: torch.Tensor) -> tuple:
        w = self.weight.to(x.dtype)
        packed = None
        body = conv7_body(x.dtype, self.in_channels, self.out_channels)
        if packs_on(x) and body == TENSOR_CORES:
            packed = pack_for_kernel(w)
        return w, self.bias.float(), packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        if torch.is_grad_enabled():
            w, bias, packed = self._kernel_args(x)
        else:
            w, bias, packed = eval_cached(self, x, lambda: (self.weight, self.bias),
                                          self._kernel_args)
        return conv7_reflect(x.contiguous(), w, bias, packed=packed)


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
