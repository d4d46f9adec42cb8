"""Layer primitives with the reference's numerics, as torch.nn modules.

The reference builds its networks as `nn.Sequential` stacks whose indices
are the state-dict names of the published checkpoints
(`model_down_seg.1.weight`, ...), so the helpers here return flat layer
lists that callers splice into their Sequentials, padding layers included.

  - reflect_conv: ReflectionPad2d(k // 2) + Conv2d(k) — two list entries;
    reflect_conv7 the same 7x7 pair, run in eval mode as one conv7 op
    (the hand-written kernel on the card) with the pad folded in, its
    kernel arguments kept between calls (`version_key`).
  - down_conv: Conv2d(3, stride 2, padding 1); conv_transpose:
    ConvTranspose2d(3, 2, padding=1, output_padding=1).
  - norm_layer('batch'): BatchNorm2d; eval mode normalizes with the
    running stats.
  - norm_layer('instance'): InstanceNorm2d(affine=False,
    track_running_stats=True); eval mode also uses the running stats (the
    behaviour the reference's single-image checkpoints depend on).
  - norm_layer('none'): Identity, which keeps the Sequential's indices.

Eval mode folds each norm that follows a conv of the block builders
(nn/blocks.py: the stems' ReflectConv7, DownConv2d, UpConvTranspose2d)
into that conv, as the eval ResnetBlock folds its own into respair: the
norm with running stats is a per-channel affine y = x * a + c
(`eval_affine`), so the conv runs with weight W * a along its
output-channel axis and bias b * a + c, both in f32 and rounded once to
x's dtype, and the norm passes its input through (`tie_norm`: the conv
holds the norm in a plain tuple, which nn.Module registers nowhere, so the
state-dict names stay the reference's). Under `torch.no_grad()` the
folded weights are kept (`eval_cached`, keyed by the conv's and the
norm's tensors); with gradients on they are made on each call from the
live tensors. `folded_calls` counts the eval conv calls that ran so.
Train mode, and norm_layer('none'), which has nothing to fold, run as
before.

Train mode normalizes with the batch's (instance norm: each sample's)
statistics and updates the running stats as torch.nn's norms do (momentum
0.1, unbiased variance), as the JAX norms do under mutable batch_stats. The
JAX package's training steps never update them (its loss engine and
train_cli say why): `update_running_stats(module, False)` turns the update
off on every norm of a module, which the port's Trainer does for the
generator and the discriminators. On a data axis of several ranks
(parallel/mesh.py) `sync_batch_norm(module, group)` makes batch norm's
train mode take the global batch's statistics, as JAX's norms do over a
sharded batch; instance norm stays per sample.

On the model axis (a frame's columns split over ranks: parallel/halo.py,
set by the generator around a frame) the layers that read across columns
take the columns they read first, from whichever ranks own them: the
eval 7x7 (`ReflectConv7`, through conv7's column-halo mode), the
reflection pads of the train-mode convs (`FoldedReflectionPad2d`,
`ReflectionPad2d`: reflection only at the image's edges, `halo.padded`),
the down convs (`DownConv2d`, `halo.down_input`) and the transposed convs
(`UpConvTranspose2d`, `halo.up_input`), whose output level is split by its
own rule, in both modes through differentiable exchanges. A shard may hold
no columns of a level: its convs run on zero columns and keep none
(`valid_conv`), so that its graph, and the collectives in it, are every
rank's. The eval norms normalise by their running stats, pointwise; in
train mode batch norm takes its statistics over its `group`, which the
trainer sets to every rank of the mesh (the data axis's samples and the
model axis's columns), and instance norm each sample's over the model
axis (the shard's group). The layers of tensors that are no pyramid
level take their shard explicitly, `forward(x, shard)`: the zero-padded
convs of the discriminators, VGG and FlowNet (`ShardConv2d`, `halo.window`)
and FlowNet's transposed convs (`ShardConvTranspose2d`, kind "transpose").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vid2vid_tpu_torch.ops.conv7 import (
    TENSOR_CORES,
    conv7_body,
    conv7_halo,
    conv7_reflect,
    pack_for_kernel,
)
from vid2vid_tpu_torch.ops.pool import max_pool_2x2
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.collectives import group_size
from vid2vid_tpu_torch.parallel.mesh import all_reduce_sum
from vid2vid_tpu_torch.utils.profiling import CONV7, DOWN, NORM, UP, span

# the eval conv calls that ran with a norm folded in (`FoldsNorm`), counted
# as the kernel wrappers count their launches
folded_calls = 0


def folded_into_conv(norm: nn.Module) -> bool:
    """Whether this call of `norm` is folded into the conv before it: tied
    to one (`tie_norm`), and both in eval mode. The norm then passes its
    input through."""
    return bool(norm._conv) and not (norm.training or norm._conv[0].training)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train mode leaves the running stats alone while
    `update_stats` is False, and takes the statistics of the global batch
    while `group` (a torch.distributed group: the data axis's ranks, and
    for the generator every rank of the mesh, whose model axis splits the
    width) holds more than one rank (`sync_batch_norm`)."""

    update_stats = True
    group = None
    _conv: tuple = ()  # (the conv it is folded into,): `tie_norm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(NORM):
            if folded_into_conv(self):
                return x
            if self.training and group_size(self.group) == 1 and halo.active(x) is not None:
                raise ValueError("BatchNorm2d in train mode on a width shard takes its statistics "
                                 "over the model axis: give it a group (sync_batch_norm)")
            if self.training and group_size(self.group) > 1:
                return self._synced(x)
            if not self.training or self.update_stats:
                return super().forward(x)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the group's global batch, in f32 (on a width
        shard, over the columns of every shard too): the mean from an
        all-reduced per-channel sum (and count), the biased variance
        from an all-reduced per-channel sum of squared deviations, both
        differentiable; the running stats, while `update_stats`, take the
        global count's unbiased variance (what F.batch_norm does on the
        whole batch)."""
        xf = x.float()
        dims = (0, 2, 3)
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        total = all_reduce_sum(torch.cat([xf.sum(dims), count]), self.group)
        n = total[-1]
        mean = total[:-1] / n
        dev = xf - mean.view(1, -1, 1, 1)
        var = all_reduce_sum((dev * dev).sum(dims), self.group) / n
        y = dev * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        if self.affine:
            y = y * self.weight.float().view(1, -1, 1, 1) + self.bias.float().view(1, -1, 1, 1)
        if self.update_stats and self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                unbiased = var.detach() * (n / (n - 1))
                self.running_mean.mul_(1 - m).add_(mean.detach().to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased.to(self.running_var.dtype), alpha=m)
        return y.to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """nn.InstanceNorm2d(track_running_stats=True) whose train mode leaves
    the running stats alone while `update_stats` is False. On a width
    shard, where it normalises by the sample's statistics (train mode, or
    no running stats), it takes them over the whole width (`_synced`)."""

    update_stats = True
    _conv: tuple = ()  # (the conv it is folded into,): `tie_norm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if folded_into_conv(self):
            return x
        shard = halo.active(x)
        if shard is not None and (self.training or not self.track_running_stats):
            return self._synced(x, shard)
        if not self.training or self.update_stats:
            return super().forward(x)
        return F.instance_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _synced(self, x: torch.Tensor, shard) -> torch.Tensor:
        """Each sample's per-channel statistics over the whole width, in
        f32: the mean from the sums over this shard's columns all-reduced
        over the model axis (the shard's group), the biased variance from
        the all-reduced sums of squared deviations, both differentiable;
        the running stats, while `update_stats` in train mode, take the
        batch's mean of them with the unbiased variance (what
        F.instance_norm does on the whole width)."""
        xf = x.float()
        n = x.shape[2] * shard.total
        mean = all_reduce_sum(xf.sum((2, 3)), shard.group) / n
        dev = xf - mean[:, :, None, None]
        var = all_reduce_sum((dev * dev).sum((2, 3)), shard.group) / n
        y = dev * torch.rsqrt(var + self.eps)[:, :, None, None]
        if self.affine:
            y = y * self.weight.float().view(1, -1, 1, 1) + self.bias.float().view(1, -1, 1, 1)
        if self.training and self.update_stats and self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                unbiased = var.detach() * (n / (n - 1))
                self.running_mean.mul_(1 - m).add_(mean.detach().mean(0), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased.mean(0), alpha=m)
        return y.to(x.dtype)


def update_running_stats(module: nn.Module, on: bool) -> list[nn.Module]:
    """Turn the train-mode running-stat update of every norm in `module` on
    or off; returns those norms."""
    norms = [m for m in module.modules() if isinstance(m, (BatchNorm2d, InstanceNorm2d))]
    for m in norms:
        m.update_stats = on
    return norms


def sync_batch_norm(module: nn.Module, group) -> None:
    """Every BatchNorm2d of `module` takes its train-mode statistics over
    the ranks of `group` (None: this process's batch alone). Instance norm
    stays per sample (over the model axis on a width shard)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """F.pad(x, (p, p, p, p), mode="reflect"); on a width shard its columns
    come from the ranks that own them (`halo.padded`, which carries the
    gradient back to them) and the reflection only at the image's edges,
    then the rows are reflected (by hand on a shard with no columns, which
    F.pad refuses)."""
    shard = halo.active(x)
    if shard is None:
        return F.pad(x, (p, p, p, p), mode="reflect")
    xp = halo.padded(x, shard, p, p, "reflect")
    if xp.shape[-1]:
        return F.pad(xp, (0, 0, p, p), mode="reflect")
    return torch.cat([xp[..., 1 : p + 1, :].flip(-2), xp, xp[..., -p - 1 : -1, :].flip(-2)], -2)


valid_conv = halo.valid_conv


class Conv2d(nn.Conv2d):
    """nn.Conv2d (VALID: the reflection pads ahead of it pad) that takes a
    width shard's input with no columns (`valid_conv`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return valid_conv(super().forward, x, self.kernel_size[1])


class ShardConv2d(nn.Conv2d):
    """nn.Conv2d with equal zero padding on both axes (the discriminators'
    4x4, VGG's 3x3 and FlowNet's convs), which also runs on a width shard
    of a tensor of any width: `forward(x, shard)`, x this rank's columns of
    a tensor shard.total wide, fetches the columns its output columns read
    (`halo.window`: zeros past the image's edges, the neighbours' columns
    at its inner sides) and returns its columns of the output, split by the
    same rule (`output_shard`); with `whole`, x is the whole tensor, which
    every rank holds, and the columns are cut from it with no exchange.
    Without a shard it is nn.Conv2d."""

    def output_width(self, width: int) -> int:
        """The output's width for an input `width` wide."""
        return halo.window_width(width, self.kernel_size[1], self.stride[1], self.padding[1])

    def output_shard(self, shard: halo.WidthShard) -> halo.WidthShard:
        return shard.of_width(self.output_width(shard.total))

    def forward(self, x: torch.Tensor, shard: halo.WidthShard | None = None,
                whole: bool = False) -> torch.Tensor:
        if shard is None:
            return super().forward(x)
        k, s, p = self.kernel_size[1], self.stride[1], self.padding[1]
        xf, _ = halo.window(x, shard, k, s, p, whole)
        return valid_conv(lambda t: F.conv2d(t, self.weight, self.bias, self.stride,
                                             (self.padding[0], 0)), xf, k)


class ShardConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with equal padding on both axes and no output
    padding (FlowNet's 4x4 stride-2 deconvs and flow upsamplings: twice the
    input's width), which also runs on a width shard, as ShardConv2d does:
    `forward(x, shard)` fetches the input columns whose taps reach this
    rank's output columns (`halo.fetch`, kind "transpose": zeros past the
    image's edges), runs the transposed conv on them with no column padding
    and keeps its columns of the output, split by the same rule
    (`output_shard`): from input columns j0.., output column c is the
    whole output's stride j0 - pad + c. Without a shard it is
    nn.ConvTranspose2d."""

    def output_width(self, width: int) -> int:
        """The output's width for an input `width` wide."""
        return halo.transpose_width(width, self.kernel_size[1], self.stride[1], self.padding[1])

    def output_shard(self, shard: halo.WidthShard) -> halo.WidthShard:
        return shard.of_width(self.output_width(shard.total))

    def forward(self, x: torch.Tensor, shard: halo.WidthShard | None = None) -> torch.Tensor:
        if shard is None:
            return super().forward(x)
        k, s, p = self.kernel_size[1], self.stride[1], self.padding[1]
        out = self.output_shard(shard)
        xf = halo.fetch(x, shard, ("transpose", k, s, p))
        y = valid_conv(lambda t: F.conv_transpose2d(t, self.weight, self.bias, self.stride,
                                                    (self.padding[0], 0)), xf, 1)
        first = out.x0 - s * halo.transpose_first(out.x0, k, s, p) + p
        return y[..., first : first + out.width]


def run_sharded(layers: nn.Sequential, x: torch.Tensor,
                shard: halo.WidthShard | None) -> tuple[torch.Tensor, halo.WidthShard | None]:
    """`layers` (a discriminator's block, a slice of VGG's features) on x:
    (output, its shard). On a width shard of a tensor that is no pyramid
    level each layer runs on the rank's columns: the convs fetch what they
    read (`ShardConv2d`), a 2x2 max pool too (ops/pool.py::max_pool_2x2),
    train-mode batch norm takes its statistics over its group, which must
    span the model axis, and instance norm each sample's over the shard's
    group (`InstanceNorm2d._synced`); activations are pointwise."""
    if shard is None:
        return layers(x), None
    for layer in layers:
        if isinstance(layer, ShardConv2d):
            x, shard = layer(x, shard), layer.output_shard(shard)
        elif isinstance(layer, nn.MaxPool2d):
            x, shard = max_pool_2x2(x, shard), shard.of_width(shard.total // 2)
        elif isinstance(layer, BatchNorm2d) and layer.training and group_size(layer.group) == 1:
            raise ValueError("BatchNorm2d in train mode on a width shard takes its statistics "
                             "over the model axis: give it a group (sync_batch_norm)")
        elif isinstance(layer, InstanceNorm2d) and (layer.training
                                                    or not layer.track_running_stats):
            x = layer._synced(x, shard)
        else:
            x = layer(x)
    return x, shard


class ReflectionPad2d(nn.ReflectionPad2d):
    """nn.ReflectionPad2d(p) (equal sides) that reads across a width shard
    (`reflect_pad`). It has no parameters: the Sequential indices, and so
    the state-dict names, stay the reference's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.padding[0])


def reflect_conv(cin: int, cout: int, kernel: int) -> list[nn.Module]:
    """ReflectionPad2d(kernel // 2) + Conv2d(cin, cout, kernel)."""
    return [ReflectionPad2d(kernel // 2), Conv2d(cin, cout, kernel)]


class FoldedReflectionPad2d(nn.ReflectionPad2d):
    """ReflectionPad2d(3) ahead of a `ReflectConv7`: it pads in train mode
    (`reflect_pad`) and passes its input through in eval mode, where the
    conv folds the reflection into its kernel's load addressing."""

    def __init__(self):
        super().__init__(3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, 3) if self.training else x


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


class FoldsNorm:
    """A conv (nn.Conv2d or nn.ConvTranspose2d) that the norm after it may
    be tied to (`tie_norm`). While both are in eval mode its calls take
    the norm's eval affine (a, c) folded into the weight (times a along
    the output-channel axis: dim 0, or dim 1 transposed) and the bias
    (b * a + c), from f32 rounded once (`folded`)."""

    _norm: tuple = ()  # (the tied norm,): a plain tuple, registered nowhere
    # (key, the call's weight args, {arg index: own parameter's name}): eval_cached
    _eval_cache: tuple | None = None

    def folded_norm(self) -> nn.Module | None:
        """The norm this call folds in, or None."""
        if not self._norm or self.training or self._norm[0].training:
            return None
        return self._norm[0]

    def folded(self, norm: nn.Module, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight in x's dtype, f32 bias) with `norm` folded in."""
        a, c = eval_affine(norm, self.out_channels, x.device)
        axis = (1, -1, 1, 1) if self.transposed else (-1, 1, 1, 1)
        return (self.weight.float() * a.view(axis)).to(x.dtype), self.bias.float() * a + c

    def library_weights(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) of a library conv's call on x: its own, or with
        the norm folded in, both in x's dtype (`eval_weights`)."""
        if self.folded_norm() is None:
            return self.weight, self.bias
        return self.eval_weights(x, lambda x, norm: tuple(
            t.to(x.dtype) for t in self.folded(norm, x)))

    def eval_weights(self, x: torch.Tensor, build) -> tuple:
        """`build(x, norm)` (the call's weight arguments; norm None when
        nothing is folded), kept under `torch.no_grad()` (`eval_cached`,
        keyed by the weight, the bias and the folded norm's tensors)."""
        norm = self.folded_norm()
        if norm is not None:
            global folded_calls
            folded_calls += 1
        if torch.is_grad_enabled():
            return build(x, norm)
        tensors = (self.weight, self.bias) if norm is None else (
            self.weight, self.bias, *state_tensors(norm))
        return eval_cached(self, x, lambda: tensors, lambda x: build(x, norm))


def tie_norm(conv: FoldsNorm, norm: nn.Module) -> None:
    """Fold `norm`, the norm after `conv` in a block builder's list, into
    `conv` in eval mode (a BatchNorm2d or an InstanceNorm2d with running
    stats; `norm_layer('none')` has nothing to fold). Each module keeps
    the other in a plain tuple, which `copy.deepcopy`'s memo points at the
    copy's own module."""
    if isinstance(norm, (BatchNorm2d, InstanceNorm2d)) and norm.track_running_stats:
        conv._norm, norm._conv = (norm,), (conv,)


class ReflectConv7(FoldsNorm, nn.Conv2d):
    """Conv2d(cin, cout, 7) behind a `FoldedReflectionPad2d`. Train mode is
    the plain conv of the padded input; eval mode runs ops.conv7.
    conv7_reflect on the unpadded input: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU one, with a tied norm folded in
    (`FoldsNorm`). Under `torch.no_grad()` its kernel arguments (the weight
    in x's dtype, the f32 bias and, on the card where `conv7_body` picks
    the tensor cores, their packed weight: bf16, or f32 as 3xTF32) are kept
    and rebuilt only when the weight or bias, or a folded norm's weight,
    bias or running stats, change (`version_key`) or x's dtype or device
    does (`eval_cached`); with gradients on they are made on each call, so
    the weights keep their gradient."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 7)

    def _kernel_args(self, x: torch.Tensor, norm: nn.Module | None) -> tuple:
        if norm is None:
            w, bias = self.weight.to(x.dtype), self.bias.float()
        else:
            w, bias = self.folded(norm, x)
        packed = None
        body = conv7_body(x.dtype, self.in_channels, self.out_channels)
        if packs_on(x) and body == TENSOR_CORES:
            packed = pack_for_kernel(w)
        return w, bias, packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(CONV7):
            if self.training:  # x is padded: no shard's width
                return valid_conv(super().forward, x, 7)
            w, bias, packed = self.eval_weights(x, self._kernel_args)
            shard = halo.active(x)
            if shard is None:
                return conv7_reflect(x.contiguous(), w, bias, packed=packed)
            strips = halo.exchange(x, shard, 3, 3)
            if not shard.width:  # no columns here: no launch
                return x.new_empty(x.shape[:1] + (self.out_channels,) + x.shape[2:])
            x_in, xoff = halo.attach(x, *strips)
            return conv7_halo(x_in, w, bias, xoff, x.shape[-1], shard.edges, packed=packed)


def reflect_conv7(cin: int, cout: int) -> list[nn.Module]:
    """`reflect_conv(cin, cout, 7)` through the conv7 kernel in eval mode:
    the same two Sequential entries, so the same state-dict names."""
    return [FoldedReflectionPad2d(), ReflectConv7(cin, cout)]


class DownConv2d(FoldsNorm, nn.Conv2d):
    """Conv2d(3, stride 2, zero padding 1), with a tied norm folded in in
    eval mode (`FoldsNorm`; kept under `torch.no_grad()`).
    On a width shard its output columns [a, b) (of the level below x's)
    read input columns 2a - 1 .. 2b - 1, wherever they lie (zeros past the
    image's edges; `halo.down_input`, differentiable)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(DOWN):
            w, bias = self.library_weights(x)
            shard = halo.active(x)
            if shard is None:
                return self._conv_forward(x, w, bias)
            return valid_conv(lambda t: F.conv2d(t, w, bias, 2, (1, 0)),
                              halo.down_input(x, shard), 3)


def down_conv(cin: int, cout: int) -> DownConv2d:
    """Conv2d(3, stride 2, padding 1): H / 2, W / 2."""
    return DownConv2d(cin, cout, 3, stride=2, padding=1)


class UpConvTranspose2d(FoldsNorm, nn.ConvTranspose2d):
    """ConvTranspose2d(3, stride 2, padding 1, output_padding 1), with a
    tied norm folded in in eval mode, as DownConv2d. On a width shard its
    output columns [a, b) (of the level above x's) read input columns
    a // 2 .. (b - 1) // 2 + 1, wherever they lie (zeros past the image's
    right edge; `halo.up_input`, differentiable): with no column padding,
    output column c of input columns from j0 = a // 2 is the level's
    column 2 j0 - 1 + c."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(UP):
            w, bias = self.library_weights(x)
            shard = halo.active(x)
            if shard is None:
                return F.conv_transpose2d(x, w, bias, 2, 1, output_padding=1)
            a, b = shard.at(shard.level - 1).bounds(shard.index)
            out = valid_conv(lambda t: F.conv_transpose2d(t, w, bias, 2, (1, 0),
                                                          output_padding=(1, 0)),
                             halo.up_input(x, shard), 1)
            first = a % 2 + 1
            return out[..., first : first + b - a]


def conv_transpose(cin: int, cout: int) -> UpConvTranspose2d:
    """ConvTranspose2d(3, stride 2, padding 1, output_padding 1): 2x H, W."""
    return UpConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)


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
