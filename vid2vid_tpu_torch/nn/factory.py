"""Network factory — the reference's define_G dispatch: the composite video
generators and the pix2pixHD single-image generators and encoder."""

from __future__ import annotations

from torch import nn

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.nn.composite import CompositeGenerator, CompositeLocalGenerator
from vid2vid_tpu_torch.nn.pix2pixhd import (
    Encoder,
    GlobalGenerator,
    GlobalWithFeatures,
    LocalEnhancer,
    LocalWithFeatures,
)

GENERATOR_KINDS = (
    "global", "local", "global_with_features", "local_with_features",
    "composite", "compositeLocal", "encoder",
)


def single_input_nc(opt: Options) -> int:
    """Channels of one encoded frame as a single-image generator takes it:
    the one-hot labels without the instance-edge channel (reference:
    vid2vid_model_G.py:239-240), or the whole encoding when label_nc is 0."""
    return opt.label_nc if opt.label_nc > 0 else opt.gen_input_nc


def define_g(
    opt: Options, kind: str | None = None, *, ngf: int | None = None,
    scale: int = 0,
) -> nn.Module:
    """Generator dispatch on --netG; ngf defaults to opt.ngf (the scale
    stack passes opt.ngf_at_scale(s) for enhancer scales). The pix2pixHD
    generators take `single_input_nc(opt)` channels (the *_with_features
    nets add the feature map to them), the encoder opt.output_nc (it
    encodes images). As in the JAX package, 'local_with_features' takes one
    enhancer level whatever --n_local_enhancers says."""
    kind = kind or opt.netG
    ngf = ngf if ngf is not None else opt.ngf
    if kind in ("composite", "compositeLocal"):
        n_in = opt.gen_input_nc * opt.n_frames_G
        prev_nc = (opt.n_frames_G - 1) * opt.output_nc
        if kind == "composite":
            return CompositeGenerator(
                n_in, prev_nc, output_nc=opt.output_nc, ngf=ngf,
                n_downsampling=opt.n_downsample_G, n_blocks=opt.n_blocks,
                norm=opt.norm, use_fg=opt.fg, no_flow=opt.effective_no_flow,
            )
        return CompositeLocalGenerator(
            n_in, prev_nc, output_nc=opt.output_nc, ngf=ngf,
            n_blocks_local=opt.n_blocks_local,
            n_downsample_g=opt.n_downsample_G, scale=scale, norm=opt.norm,
            use_fg=opt.fg, no_flow=opt.effective_no_flow,
        )
    if kind == "encoder":
        return Encoder(opt.output_nc, opt.feat_num, ngf, opt.n_downsample_G, opt.norm)
    n_in = single_input_nc(opt)
    dims = dict(output_nc=opt.output_nc, ngf=ngf, norm=opt.norm)
    local = dict(n_downsample_global=opt.n_downsample_G, n_blocks_global=opt.n_blocks,
                 n_blocks_local=opt.n_blocks_local, **dims)
    if kind == "global":
        return GlobalGenerator(n_in, n_downsampling=opt.n_downsample_G,
                               n_blocks=opt.n_blocks, **dims)
    if kind == "local":
        return LocalEnhancer(n_in, n_local_enhancers=opt.n_local_enhancers, **local)
    if kind == "global_with_features":
        return GlobalWithFeatures(n_in, feat_num=opt.feat_num,
                                  n_downsampling=opt.n_downsample_G,
                                  n_blocks=opt.n_blocks, **dims)
    if kind == "local_with_features":
        return LocalWithFeatures(n_in, feat_num=opt.feat_num, **local)
    raise ValueError(f"unknown --netG {kind!r}; expected one of {GENERATOR_KINDS}")
