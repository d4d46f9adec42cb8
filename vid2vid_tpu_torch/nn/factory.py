"""Network factory — the reference's define_G dispatch, for the generator
kinds this port has so far."""

from __future__ import annotations

from torch import nn

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.nn.composite import CompositeGenerator, CompositeLocalGenerator

GENERATOR_KINDS = ("composite", "compositeLocal")
_NOT_PORTED = (
    "global", "local", "global_with_features", "local_with_features", "encoder",
)


def define_g(
    opt: Options, kind: str | None = None, *, ngf: int | None = None,
    scale: int = 0,
) -> nn.Module:
    """Generator dispatch on --netG; ngf defaults to opt.ngf (the scale
    stack passes opt.ngf_at_scale(s) for enhancer scales)."""
    kind = kind or opt.netG
    ngf = ngf if ngf is not None else opt.ngf
    input_nc = opt.gen_input_nc * opt.n_frames_G
    prev_nc = (opt.n_frames_G - 1) * opt.output_nc
    if kind == "composite":
        return CompositeGenerator(
            input_nc, prev_nc, output_nc=opt.output_nc, ngf=ngf,
            n_downsampling=opt.n_downsample_G, n_blocks=opt.n_blocks,
            norm=opt.norm, use_fg=opt.fg, no_flow=opt.effective_no_flow,
        )
    if kind == "compositeLocal":
        return CompositeLocalGenerator(
            input_nc, prev_nc, output_nc=opt.output_nc, ngf=ngf,
            n_blocks_local=opt.n_blocks_local,
            n_downsample_g=opt.n_downsample_G, scale=scale, norm=opt.norm,
            use_fg=opt.fg, no_flow=opt.effective_no_flow,
        )
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"--netG {kind!r} (the pix2pixHD single-image generators and the "
            "feature encoder) is not ported yet (ROADMAP.md, queue 1: "
            "single-image generators)"
        )
    raise ValueError(
        f"unknown --netG {kind!r}; expected one of {GENERATOR_KINDS + _NOT_PORTED}"
    )
