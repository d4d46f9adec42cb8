"""PatchGAN discriminators (NCHW), with the reference's state-dict names.

NLayerDiscriminator (reference: models/networks.py:679-725): 4x4 convs with
zero padding 2 (stride 2, then stride 1 for the last two), the channel
count doubling up to 512, LeakyReLU(0.2), a 1-channel patch map; with
intermediate features it returns every block's activations for the
feature-matching loss. The blocks are the Sequentials `layer{n}` of the
reference's getIntermFeat layout.

MultiscaleDiscriminator (reference: models/networks.py:634-675): num_D
copies over an input pyramid (3x3/s2 average pooling between copies). Copy
i runs at the i-th level and is named `scale{num_D-1-i}` with
min(64, ndf * 2**i) channels, so `scale{num_D-1}` sees full resolution
with ndf channels; its blocks are `scale{d}_layer{n}`.

On the model axis (`forward(x, shard)`: x this rank's columns of frames
shard.total wide, parallel/halo.py) every copy runs on the rank's columns,
as the JAX mesh partitions it: each 4x4 conv fetches the columns its output
columns read (nn/layers.py::ShardConv2d; a stride-2 layer's output is W / 2
+ 1 wide, a stride-1 layer's W + 1, each split by the same rule), the
train-mode norms take their statistics over the whole width
(`run_sharded`), and the pyramid between copies is the sharded 3x3/s2
average pool. The features for feature matching stay at the rank's
columns; `widths` gives the whole widths of the outputs (the losses'
shares, losses.py).
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.nn.layers import ShardConv2d, norm_layer, run_sharded
from vid2vid_tpu_torch.ops.pool import avg_pool_3x3s2
from vid2vid_tpu_torch.parallel import halo


def nlayer_blocks(input_nc: int, ndf: int, n_layers: int, norm: str) -> list[nn.Sequential]:
    """The n_layers + 2 Sequential blocks of one NLayerDiscriminator."""
    blocks = [nn.Sequential(ShardConv2d(input_nc, ndf, 4, 2, 2), nn.LeakyReLU(0.2, True))]
    nf = ndf
    for n in range(1, n_layers + 1):
        nf_prev, nf = nf, min(nf * 2, 512)
        stride = 2 if n < n_layers else 1
        blocks.append(nn.Sequential(
            ShardConv2d(nf_prev, nf, 4, stride, 2), norm_layer(norm, nf),
            nn.LeakyReLU(0.2, True),
        ))
    blocks.append(nn.Sequential(ShardConv2d(nf, 1, 4, 1, 2)))
    return blocks


class MultiscaleDiscriminator(nn.Module):
    """num_D PatchGANs over a 3x3/s2 input pyramid.

    forward returns a list, finest resolution first, of per-copy feature
    lists: every block's activation with `get_interm_feat`, else the patch
    map alone.
    """

    def __init__(
        self, input_nc: int, ndf: int = 64, n_layers: int = 3,
        norm: str = "batch", num_d: int = 3, get_interm_feat: bool = False,
    ):
        super().__init__()
        self.num_d, self.n_layers = num_d, n_layers
        self.get_interm_feat = get_interm_feat
        for i in range(num_d):
            d = num_d - 1 - i
            blocks = nlayer_blocks(input_nc, min(64, ndf * 2**i), n_layers, norm)
            for n, blk in enumerate(blocks):
                self.add_module(f"scale{d}_layer{n}", blk)

    def forward(self, x: torch.Tensor,
                shard: halo.WidthShard | None = None) -> list[list[torch.Tensor]]:
        """With `shard` (x this rank's columns of frames shard.total wide)
        every activation is this rank's columns of the whole one's."""
        results = []
        for i in range(self.num_d):
            d = self.num_d - 1 - i
            feats, h, sh = [], x, shard
            for n in range(self.n_layers + 2):
                h, sh = run_sharded(getattr(self, f"scale{d}_layer{n}"), h, sh)
                feats.append(h)
            results.append(feats if self.get_interm_feat else [h])
            if i != self.num_d - 1:
                x = avg_pool_3x3s2(x, shard)
                shard = None if shard is None else shard.of_width(
                    halo.window_width(shard.total, 3, 2, 1))
        return results

    def widths(self, width: int) -> list[list[int]]:
        """The whole widths of forward's outputs, nested as they are, for
        an input `width` wide."""
        out = []
        for i in range(self.num_d):
            d, ws, w = self.num_d - 1 - i, [], width
            for n in range(self.n_layers + 2):
                w = getattr(self, f"scale{d}_layer{n}")[0].output_width(w)
                ws.append(w)
            out.append(ws if self.get_interm_feat else ws[-1:])
            width = halo.window_width(width, 3, 2, 1)
        return out
