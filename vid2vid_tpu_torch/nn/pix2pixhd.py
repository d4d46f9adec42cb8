"""The single-image (pix2pixHD) generators and the instance-feature encoder.

The `--use_single_G` first-frame path runs them (reference:
models/vid2vid_model_G.py:237-320); `define_g` builds them on their own.

  GlobalGenerator     `model`: stem, downs, resblocks, ups, tanh head
  LocalEnhancer       pix2pixHD's `model` (the global trunk at ngf * 2**n
                      without its head), `model{n}_1` (stem + down) and
                      `model{n}_2` (resblocks + up, the head after the last)
  GlobalWithFeatures  the reference's Global_with_z: `model_downsample`,
                      `model_resnet`, `model_upsample`, `model_upsample_conv`
  LocalWithFeatures   no published checkpoint names it; this port's names:
                      `model_downsample`, `model_resnet`, `model_upsample`
                      (the global trunk, as in GlobalWithFeatures, without
                      its head), `model{n}_1`, `model{n}_2` (as in
                      LocalEnhancer, without the head) and `model_final`
                      (the tanh head)
  Encoder             `model`: stem, downs, ups, tanh head; then
                      `instance_average`

Inputs are NCHW. The feature map z (B, feat_num, H, W) enters the *_with_
features nets where the JAX package's (vid2vid_tpu/nn/pix2pixhd.py) does:
concatenated to the input, to the resblock stack and the first up block
(average-pooled to their size), and to the head. Channel widths are capped
at 1024. The 7x7 stems and heads run through the conv7 kernel in eval mode
(nn/layers.py::reflect_conv7) and every eval ResnetBlock through respair.
"""

from __future__ import annotations

import torch
from torch import nn

from vid2vid_tpu_torch.nn.blocks import ResnetBlock, conv_stem, down_block, tanh_head, up_block
from vid2vid_tpu_torch.ops.pool import avg_pool_3x3s2

_CH_MAX = 1024


def _width(ngf: int, i: int) -> int:
    return min(_CH_MAX, ngf * 2**i)


def _downs(ngf: int, nd: int, norm: str) -> list[nn.Module]:
    layers: list[nn.Module] = []
    for i in range(nd):
        layers += down_block(_width(ngf, i), _width(ngf, i + 1), norm)
    return layers


def _ups(ngf: int, nd: int, norm: str, extra_in: int = 0) -> list[nn.Module]:
    """nd up blocks from width ngf * 2**nd (+ extra_in on the first)."""
    layers: list[nn.Module] = []
    for i in range(nd):
        cin = _width(ngf, nd - i) + (extra_in if i == 0 else 0)
        layers += up_block(cin, _width(ngf, nd - 1 - i), norm)
    return layers


def _pool(x: torch.Tensor, times: int) -> torch.Tensor:
    for _ in range(times):
        x = avg_pool_3x3s2(x)
    return x


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, 1)


def _enhancer(
    cin: int, ngf_n: int, n_blocks: int, norm: str, res_extra: int = 0
) -> tuple[nn.Sequential, list[nn.Module]]:
    """One enhancer level: (`model{n}_1`, the layers of `model{n}_2`)."""
    down = nn.Sequential(*conv_stem(cin, ngf_n, norm, conv7=True),
                         *down_block(ngf_n, ngf_n * 2, norm))
    width = ngf_n * 2 + res_extra
    up = [ResnetBlock(width, norm) for _ in range(n_blocks)] + up_block(width, ngf_n, norm)
    return down, up


class GlobalGenerator(nn.Module):
    """pix2pixHD's global generator; `final_head=False` drops the tanh head
    (the LocalEnhancer's trunk). `forward(x, feat=None)` concatenates feat
    to x when given (input_nc counts both)."""

    def __init__(
        self, input_nc: int, output_nc: int = 3, ngf: int = 64,
        n_downsampling: int = 3, n_blocks: int = 9, norm: str = "instance",
        final_head: bool = True,
    ):
        super().__init__()
        nd = n_downsampling
        layers = conv_stem(input_nc, ngf, norm, conv7=True) + _downs(ngf, nd, norm)
        layers += [ResnetBlock(_width(ngf, nd), norm) for _ in range(n_blocks)]
        layers += _ups(ngf, nd, norm)
        if final_head:
            layers += tanh_head(ngf, output_nc, conv7=True)
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, feat: torch.Tensor | None = None) -> torch.Tensor:
        return self.model(x if feat is None else _cat(x, feat))


class LocalEnhancer(nn.Module):
    """The global trunk at 1/2**n_local_enhancers of the input, then one
    enhancer (stem + down, + the coarser output, resblocks + up) per level."""

    def __init__(
        self, input_nc: int, output_nc: int = 3, ngf: int = 32,
        n_downsample_global: int = 3, n_blocks_global: int = 9,
        n_local_enhancers: int = 1, n_blocks_local: int = 3, norm: str = "instance",
    ):
        super().__init__()
        self.n_local = n_local_enhancers
        self.model = GlobalGenerator(
            input_nc, output_nc, ngf * 2**n_local_enhancers, n_downsample_global,
            n_blocks_global, norm, final_head=False,
        ).model
        for n in range(1, n_local_enhancers + 1):
            down, up = _enhancer(input_nc, ngf * 2 ** (n_local_enhancers - n),
                                 n_blocks_local, norm)
            if n == n_local_enhancers:
                up += tanh_head(ngf, output_nc, conv7=True)
            setattr(self, f"model{n}_1", down)
            setattr(self, f"model{n}_2", nn.Sequential(*up))

    def forward(self, x: torch.Tensor, feat: torch.Tensor | None = None) -> torch.Tensor:
        if feat is not None:
            x = _cat(x, feat)
        pyramid = [x]
        for _ in range(self.n_local):
            pyramid.append(avg_pool_3x3s2(pyramid[-1]))
        out = self.model(pyramid[-1])
        for n in range(1, self.n_local + 1):
            h = getattr(self, f"model{n}_1")(pyramid[self.n_local - n])
            out = getattr(self, f"model{n}_2")(h + out)
        return out


class GlobalWithFeatures(nn.Module):
    """The global generator with the feature map z injected at every stage
    (the reference's Global_with_z): `forward(x, z)`."""

    def __init__(
        self, input_nc: int, output_nc: int = 3, feat_num: int = 16, ngf: int = 64,
        n_downsampling: int = 3, n_blocks: int = 9, norm: str = "instance",
    ):
        super().__init__()
        nd, ch = n_downsampling, _width(ngf, n_downsampling)
        self.nd = nd
        self.model_downsample = nn.Sequential(
            *conv_stem(input_nc + feat_num, ngf, norm, conv7=True), *_downs(ngf, nd, norm))
        self.model_resnet = nn.Sequential(
            *[ResnetBlock(ch + feat_num, norm) for _ in range(n_blocks)])
        self.model_upsample = nn.Sequential(*_ups(ngf, nd, norm, extra_in=2 * feat_num))
        self.model_upsample_conv = nn.Sequential(
            *tanh_head(ngf + feat_num, output_nc, conv7=True))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        z_down = _pool(z, self.nd)
        h = self.model_downsample(_cat(x, z))
        h = self.model_resnet(_cat(h, z_down))
        h = self.model_upsample(_cat(h, z_down))
        return self.model_upsample_conv(_cat(h, z))


class LocalWithFeatures(nn.Module):
    """The LocalEnhancer with the feature map z injected at every stage, as
    the JAX package's LocalWithFeatures wires it: `forward(x, z)`."""

    def __init__(
        self, input_nc: int, output_nc: int = 3, feat_num: int = 16, ngf: int = 32,
        n_downsample_global: int = 3, n_blocks_global: int = 9,
        n_local_enhancers: int = 1, n_blocks_local: int = 3, norm: str = "instance",
    ):
        super().__init__()
        n_local, nd = n_local_enhancers, n_downsample_global
        self.n_local, self.nd = n_local, nd
        ngf_g = ngf * 2**n_local
        ch = _width(ngf_g, nd)
        self.model_downsample = nn.Sequential(
            *conv_stem(input_nc + feat_num, ngf_g, norm, conv7=True), *_downs(ngf_g, nd, norm))
        self.model_resnet = nn.Sequential(
            *[ResnetBlock(ch + feat_num, norm) for _ in range(n_blocks_global)])
        self.model_upsample = nn.Sequential(*_ups(ngf_g, nd, norm, extra_in=2 * feat_num))
        for n in range(1, n_local + 1):
            down, up = _enhancer(
                input_nc + (feat_num if n == n_local else 0), ngf * 2 ** (n_local - n),
                n_blocks_local, norm, res_extra=feat_num if n == 1 else 0)
            setattr(self, f"model{n}_1", down)
            setattr(self, f"model{n}_2", nn.Sequential(*up))
        self.model_final = nn.Sequential(*tanh_head(ngf + feat_num, output_nc, conv7=True))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        pyramid = [x]
        for _ in range(self.n_local):
            pyramid.append(avg_pool_3x3s2(pyramid[-1]))
        z_local = _pool(z, self.n_local)
        z_global = _pool(z_local, self.nd)
        h = self.model_downsample(_cat(pyramid[-1], z_local))
        h = self.model_resnet(_cat(h, z_global))
        out = self.model_upsample(_cat(h, z_global))
        for n in range(1, self.n_local + 1):
            inp = pyramid[self.n_local - n]
            e = getattr(self, f"model{n}_1")(_cat(inp, z) if n == self.n_local else inp) + out
            out = getattr(self, f"model{n}_2")(_cat(e, z_local) if n == 1 else e)
        return self.model_final(_cat(out, z))


class Encoder(nn.Module):
    """The instance-feature encoder: a conv U-stack whose output each
    instance of `inst` replaces by its mean (`instance_average`)."""

    def __init__(
        self, input_nc: int = 3, output_nc: int = 16, ngf: int = 16,
        n_downsampling: int = 4, norm: str = "instance",
    ):
        super().__init__()
        nd = n_downsampling
        self.output_nc = output_nc
        layers = conv_stem(input_nc, ngf, norm, conv7=True)
        for i in range(nd):
            layers += down_block(ngf * 2**i, ngf * 2 ** (i + 1), norm)
        for i in range(nd):
            layers += up_block(ngf * 2 ** (nd - i), ngf * 2 ** (nd - 1 - i), norm)
        layers += tanh_head(ngf, output_nc, conv7=True)
        self.model = nn.Sequential(*layers)

    def forward(
        self, x: torch.Tensor, inst: torch.Tensor, max_instances: int = 64
    ) -> torch.Tensor:
        return instance_average(self.model(x), inst, max_instances)


def instance_average(
    feat: torch.Tensor, inst: torch.Tensor, max_instances: int = 64
) -> torch.Tensor:
    """Each instance's features replaced by their spatial mean.

    feat: (B, C, H, W); inst: (B, H, W) or (B, 1, H, W) integer ids. The JAX
    package's static cap holds: per image, the `max_instances` smallest ids
    get a segment each, and larger ids fall into the last of them.
    """
    if inst.dim() == 4:
        inst = inst[:, 0]
    b, c, h, w = feat.shape
    out = torch.empty_like(feat)
    for i in range(b):
        ids = inst[i].reshape(-1).to(device=feat.device, dtype=torch.int64)
        uniq = torch.unique(ids)[:max_instances]  # sorted
        seg = torch.searchsorted(uniq, ids).clamp_(max=max_instances - 1)
        f = feat[i].reshape(c, h * w)
        sums = torch.zeros((c, uniq.numel()), dtype=feat.dtype, device=feat.device)
        sums.index_add_(1, seg, f)
        counts = torch.zeros(uniq.numel(), dtype=feat.dtype, device=feat.device)
        counts.index_add_(0, seg, torch.ones_like(f[0]))
        out[i] = (sums / counts.clamp(min=1.0))[:, seg].view(c, h, w)
    return out
