"""The repeated motifs of the reference's Sequential stacks.

`conv_stem`, `down_block`, `up_block`, `tanh_head` and `conv_head` return
flat layer lists (the JAX package's ConvStem, DownBlock, UpBlock, TanhHead
and ConvHead modules): the reference splices them into one Sequential per
trunk, and its indices are the checkpoint's names. `ResnetBlock` is a
module, as in the reference, with its `conv_block` Sequential. Every 7x7
stem and head is a `reflect_conv7`: in eval mode it runs the conv7 kernel
(the composite generators of nn/composite.py and the single-image nets of
nn/pix2pixhd.py alike). No eval norm runs a pass of its own: the stems,
down and up blocks tie their norm to the conv before it
(nn/layers.py::tie_norm), which folds it into its weight and bias while
both are in eval mode, and the eval ResnetBlock folds its two into
respair's epilogues. Train mode runs every norm as before, and
norm_layer('none') has nothing to fold. On a width shard (parallel/halo.py) the layers
take their neighbours' columns first (nn/layers.py); the eval
`ResnetBlock` runs respair's column-halo mode, the train-mode one its
plain layers, whose two reflection pads exchange a column a side each.
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.nn.layers import (
    conv_transpose,
    down_conv,
    eval_affine,
    eval_cached,
    norm_layer,
    packs_on,
    reflect_conv,
    reflect_conv7,
    state_tensors,
    tie_norm,
)
from vid2vid_tpu_torch.ops.conv7 import pack_for_kernel
from vid2vid_tpu_torch.ops.respair import respair, respair_halo
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.utils.profiling import RESBLOCK, span


def _tied(conv: nn.Module, norm: str, cout: int) -> list[nn.Module]:
    """[conv, its norm], the norm folded into the conv in eval mode
    (nn/layers.py::tie_norm)."""
    layer = norm_layer(norm, cout)
    tie_norm(conv, layer)
    return [conv, layer]


def conv_stem(cin: int, cout: int, norm: str) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 + norm + ReLU (4 entries); the 7x7 conv
    runs the conv7 kernel in eval mode (reflect_conv7), the norm folded
    into it."""
    pad, conv = reflect_conv7(cin, cout)
    return [pad, *_tied(conv, norm, cout), nn.ReLU(True)]


def down_block(cin: int, cout: int, norm: str) -> list[nn.Module]:
    """Conv3x3 stride 2, zero padding 1, + norm + ReLU (3 entries); eval
    folds the norm into the conv."""
    return [*_tied(down_conv(cin, cout), norm, cout), nn.ReLU(True)]


def up_block(cin: int, cout: int, norm: str) -> list[nn.Module]:
    """ConvTranspose(3, s2, p1, op1) + norm + ReLU (3 entries); eval folds
    the norm into the conv."""
    return [*_tied(conv_transpose(cin, cout), norm, cout), nn.ReLU(True)]


def tanh_head(cin: int, cout: int) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 + tanh (3 entries), the conv as in
    conv_stem."""
    return [*reflect_conv7(cin, cout), nn.Tanh()]


def conv_head(cin: int, cout: int, sigmoid: bool = False) -> list[nn.Module]:
    """ReflectionPad(3) + Conv7x7 [+ sigmoid] (the flow and weight heads),
    the conv as in conv_stem."""
    return [*reflect_conv7(cin, cout)] + ([nn.Sigmoid()] if sigmoid else [])


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 residual block: x + norm(conv(relu(norm(conv(x))))).

    Training runs the plain layers. Eval folds each conv bias and eval-mode
    norm into one affine (a, c + bias * a) and runs the whole block as one
    `ops.respair` — the CUDA kernel on a CUDA tensor, for any width. Under
    `torch.no_grad()` the folded affines, the weights in x's dtype and, on
    the card, their packed layout for the tensor-core body (bf16, or f32 as
    3xTF32: twice the f32 weight's bytes) are kept, and rebuilt only when a
    parameter or buffer of the block changes (its version counter, storage,
    dtype or device) or x's dtype or device does (`nn.layers.eval_cached`);
    with gradients on they are rebuilt on each call, so the weights keep
    their gradient. On a width shard, eval takes two columns a side, from
    whichever ranks own them, and runs `ops.respair_halo` (one exchange
    for both convs); train mode's two pads take one each
    (nn/layers.py::ReflectionPad2d).
    """

    def __init__(self, dim: int, norm: str = "batch"):
        super().__init__()
        self.dim = dim
        self.conv_block = nn.Sequential(
            *reflect_conv(dim, dim, 3), norm_layer(norm, dim), nn.ReLU(True),
            *reflect_conv(dim, dim, 3), norm_layer(norm, dim),
        )
        # (key, respair's weight args, {arg index: own parameter's name})
        self._eval_cache: tuple | None = None

    def _folded(self, conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor):
        a, c = eval_affine(norm, self.dim, x.device)
        return conv.weight.to(x.dtype), (a, c + conv.bias.float() * a)

    def _respair_args(self, x: torch.Tensor) -> tuple:
        """(k0, ab0, k1, ab1, packed) of `respair` for x."""
        blk = self.conv_block
        k0, ab0 = self._folded(blk[1], blk[2], x)
        k1, ab1 = self._folded(blk[5], blk[6], x)
        packed = None
        if packs_on(x):  # the tensor-core body's (bf16; f32 as 3xTF32)
            packed = (pack_for_kernel(k0), pack_for_kernel(k1))
        return k0, ab0, k1, ab1, packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(RESBLOCK):
            if self.training:
                return x + self.conv_block(x)
            if torch.is_grad_enabled():
                k0, ab0, k1, ab1, packed = self._respair_args(x)
            else:
                k0, ab0, k1, ab1, packed = eval_cached(
                    self, x, lambda: state_tensors(self.conv_block), self._respair_args)
            shard = halo.active(x)
            if shard is None:
                return respair(x.contiguous(), k0, ab0, k1, ab1, packed=packed)
            x = x.contiguous()
            strips = halo.exchange(x, shard, 2, 2)
            if not shard.width:  # no columns here: no launch
                return x
            x_in, xoff = halo.attach(x, *strips)
            return respair_halo(x, x_in, xoff, shard.edges, k0, ab0, k1, ab1, packed=packed)
