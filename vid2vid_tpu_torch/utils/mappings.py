"""The reference's state-dict names against the JAX package's variable paths.

The port's own copy of the name mappings of
vid2vid_tpu/utils/torch_import.py (tests/test_torch_imports.py holds the
two equal): the composite generators, the pix2pixHD single-image
generators and encoder, the multiscale PatchGAN, the flow nets and
torchvision's VGG19. Each mapping yields
(torch_key, (collection, flax_path...), kind) triples; `convert_tensor`
turns a reference tensor into the JAX package's layout:

  Conv2d          (O, I, kH, kW) -> HWIO
  ConvTranspose2d (I, O, kH, kW) -> (kH, kW, I, O)
  norm weight/bias -> scale/bias params; running stats -> batch_stats.

numpy only; `utils/from_jax.py` runs the mappings backwards.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

Triple = tuple[str, tuple, str]  # torch key, flax path, kind


def convert_tensor(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == "convT":
        return np.transpose(arr, (2, 3, 0, 1))
    return np.asarray(arr)


def _conv(tkey: str, fpath: tuple, bias: bool = True) -> Iterator[Triple]:
    yield f"{tkey}.weight", ("params", *fpath, "kernel"), "conv"
    if bias:
        yield f"{tkey}.bias", ("params", *fpath, "bias"), "copy"


def _convT(tkey: str, fpath: tuple, bias: bool = True) -> Iterator[Triple]:
    yield f"{tkey}.weight", ("params", *fpath, "kernel"), "convT"
    if bias:
        yield f"{tkey}.bias", ("params", *fpath, "bias"), "copy"


def _norm(tkey: str, fpath: tuple, kind: str) -> Iterator[Triple]:
    """kind: 'batch' (affine + stats) or 'instance' (stats only)."""
    inner = "BatchNorm_0" if kind == "batch" else "InstanceNorm_0"
    if kind == "batch":
        yield f"{tkey}.weight", ("params", *fpath, inner, "scale"), "copy"
        yield f"{tkey}.bias", ("params", *fpath, inner, "bias"), "copy"
    yield f"{tkey}.running_mean", ("batch_stats", *fpath, inner, "mean"), "copy"
    yield f"{tkey}.running_var", ("batch_stats", *fpath, inner, "var"), "copy"


def _resblock(tkey: str, fpath: tuple, norm: str) -> Iterator[Triple]:
    """ResnetBlock: conv_block Sequential [pad, conv, norm, act, pad, conv, norm]."""
    yield from _conv(f"{tkey}.conv_block.1", (*fpath, "Conv_0"))
    yield from _norm(f"{tkey}.conv_block.2", (*fpath, "Norm_0"), norm)
    yield from _conv(f"{tkey}.conv_block.5", (*fpath, "Conv_1"))
    yield from _norm(f"{tkey}.conv_block.6", (*fpath, "Norm_1"), norm)


def _stem(tkey: str, idx: int, fpath: tuple, norm: str) -> Iterator[Triple]:
    """[ReflectionPad, Conv7, norm, ReLU] at sequential offset idx."""
    yield from _conv(f"{tkey}.{idx + 1}", (*fpath, "Conv_0"))
    yield from _norm(f"{tkey}.{idx + 2}", (*fpath, "Norm_0"), norm)


def _upstack_res(
    tkey: str, fpath: tuple, n_res: int, n_up: int, norm: str
) -> Iterator[Triple]:
    """The JAX _UpStack (resblocks then up blocks) <- one Sequential."""
    for k in range(n_res):
        yield from _resblock(f"{tkey}.{k}", (*fpath, f"ResnetBlock_{k}"), norm)
    for i in range(n_up):
        base = n_res + 3 * i
        yield from _convT(
            f"{tkey}.{base}", (*fpath, f"UpBlock_{i}", "ConvTranspose_0")
        )
        yield from _norm(
            f"{tkey}.{base + 1}", (*fpath, f"UpBlock_{i}", "Norm_0"), norm
        )


# --------------------------------------------------------------- composite


def _fused_stem(use_fg: bool) -> list[Triple]:
    """Stem convs fused into the JAX block conv `stems` (per-branch params)."""
    out: list[Triple] = []
    for tname, fname in [("model_down_seg", "down_seg"), ("model_down_img", "down_img")] + (
        [("indv_down", "fg")] if use_fg else []
    ):
        out.append((f"{tname}.1.weight", ("params", "stems", f"{fname}_kernel"), "conv"))
        out.append((f"{tname}.1.bias", ("params", "stems", f"{fname}_bias"), "copy"))
    return out


def _trunk_tail(
    tkey: str, fpath: tuple, n_down: int, n_res: int, norm: str
) -> list[Triple]:
    """Post-stem trunk: stem norm at index 2, downs, resblocks."""
    out: list[Triple] = list(_norm(f"{tkey}.2", (*fpath, "stem_norm"), norm))
    for i in range(n_down):
        base = 4 + 3 * i
        out += _conv(f"{tkey}.{base}", (*fpath, f"DownBlock_{i}", "Conv_0"))
        out += _norm(f"{tkey}.{base + 1}", (*fpath, f"DownBlock_{i}", "Norm_0"), norm)
    res_base = 4 + 3 * n_down
    for k in range(n_res):
        out += _resblock(f"{tkey}.{res_base + k}", (*fpath, f"ResnetBlock_{k}"), norm)
    return out


def _fused_heads(use_fg: bool, no_flow: bool) -> list[Triple]:
    out: list[Triple] = [
        ("model_final_img.1.weight", ("params", "heads", "final_img_kernel"), "conv"),
        ("model_final_img.1.bias", ("params", "heads", "final_img_bias"), "copy"),
    ]
    if not no_flow:
        out += [
            (
                ("model_final_flow.1.weight", "model_final_w.1.weight"),
                ("params", "heads", "final_fw_kernel"), "concat_conv",
            ),
            (
                ("model_final_flow.1.bias", "model_final_w.1.bias"),
                ("params", "heads", "final_fw_bias"), "concat_copy",
            ),
        ]
    if use_fg:
        out += [
            ("indv_final.1.weight", ("params", "heads", "fg_final_kernel"), "conv"),
            ("indv_final.1.bias", ("params", "heads", "fg_final_bias"), "copy"),
        ]
    return out


def composite_generator_mapping(
    n_downsampling: int = 3,
    n_blocks: int = 9,
    norm: str = "batch",
    use_fg: bool = False,
    no_flow: bool = False,
) -> list[Triple]:
    """CompositeGenerator (reference: models/networks.py:117-232)."""
    n_res_down = n_blocks - n_blocks // 2
    n_res_up = n_blocks // 2
    out: list[Triple] = _fused_stem(use_fg)
    out += _trunk_tail("model_down_seg", ("down_seg",), n_downsampling, n_res_down, norm)
    out += _trunk_tail("model_down_img", ("down_img",), n_downsampling, n_res_down, norm)
    for k in range(n_res_up):
        out += _resblock(f"model_res_img.{k}", ("up_img", f"ResnetBlock_{k}"), norm)
    out += _upstack_res("model_up_img", ("up_img",), 0, n_downsampling, norm)
    if not no_flow:
        for k in range(n_res_up):
            out += _resblock(
                f"model_res_flow.{k}", ("up_flow", f"ResnetBlock_{k}"), norm
            )
        out += _upstack_res("model_up_flow", ("up_flow",), 0, n_downsampling, norm)
    if use_fg:
        out += _trunk_tail("indv_down", ("fg_down",), n_downsampling, 0, norm)
        for k in range(n_blocks):
            out += _resblock(f"indv_res.{k}", ("fg_down", f"ResnetBlock_{k}"), norm)
        out += _upstack_res("indv_up", ("fg_up",), 0, n_downsampling, norm)
    out += _fused_heads(use_fg, no_flow)
    return out


def _fused_up_pair(n_res: int, norm: str) -> list[Triple]:
    """model_up_img + model_up_flow -> the JAX fused `up_pair` module."""
    out: list[Triple] = []
    for br, tkey in (("img", "model_up_img"), ("flow", "model_up_flow")):
        for k in range(n_res):
            blk = ("up_pair", f"res{k}")
            for j, tconv in ((0, 1), (1, 5)):
                out += [
                    (
                        f"{tkey}.{k}.conv_block.{tconv}.weight",
                        ("params", *blk, f"{br}_conv{j}_kernel"), "conv",
                    ),
                    (
                        f"{tkey}.{k}.conv_block.{tconv}.bias",
                        ("params", *blk, f"{br}_conv{j}_bias"), "copy",
                    ),
                ]
                out += _norm(
                    f"{tkey}.{k}.conv_block.{tconv + 1}",
                    (*blk, f"{br}_norm{j}"), norm,
                )
        out += [
            (
                f"{tkey}.{n_res}.weight",
                ("params", "up_pair", "up0", f"{br}_kernel"), "convT",
            ),
            (
                f"{tkey}.{n_res}.bias",
                ("params", "up_pair", "up0", f"{br}_bias"), "copy",
            ),
        ]
        out += _norm(
            f"{tkey}.{n_res + 1}", ("up_pair", "up0", f"{br}_norm"), norm
        )
    return out


def composite_local_mapping(
    n_blocks_local: int = 3,
    norm: str = "batch",
    use_fg: bool = False,
    no_flow: bool = False,
) -> list[Triple]:
    """CompositeLocalGenerator (reference: models/networks.py:234-325)."""
    out: list[Triple] = _fused_stem(use_fg)
    out += _trunk_tail("model_down_seg", ("down_seg",), 1, 0, norm)
    out += _trunk_tail("model_down_img", ("down_img",), 1, 0, norm)
    if no_flow:
        out += _upstack_res("model_up_img", ("up_img",), n_blocks_local, 1, norm)
    else:
        out += _fused_up_pair(n_blocks_local, norm)
    if use_fg:
        out += _trunk_tail("indv_down", ("fg_down",), 1, 0, norm)
        out += _upstack_res("indv_up", ("fg_up",), n_blocks_local, 1, norm)
    out += _fused_heads(use_fg, no_flow)
    return out


# ------------------------------------------------------------- pix2pixHD


def global_generator_mapping(
    n_downsampling: int = 3, n_blocks: int = 9, norm: str = "instance"
) -> list[Triple]:
    """GlobalGenerator's single `model` Sequential -> the JAX module list."""
    out: list[Triple] = []
    out += _stem("model", 0, ("ConvStem_0",), norm)
    idx = 4
    for i in range(n_downsampling):
        out += _conv(f"model.{idx}", (f"DownBlock_{i}", "Conv_0"))
        out += _norm(f"model.{idx + 1}", (f"DownBlock_{i}", "Norm_0"), norm)
        idx += 3
    for k in range(n_blocks):
        out += _resblock(f"model.{idx}", (f"ResnetBlock_{k}",), norm)
        idx += 1
    for i in range(n_downsampling):
        out += _convT(f"model.{idx}", (f"UpBlock_{i}", "ConvTranspose_0"))
        out += _norm(f"model.{idx + 1}", (f"UpBlock_{i}", "Norm_0"), norm)
        idx += 3
    out += _conv(f"model.{idx + 1}", ("TanhHead_0", "Conv_0"))
    return out


def global_with_features_mapping(
    n_downsampling: int = 3, n_blocks: int = 9, norm: str = "instance"
) -> list[Triple]:
    """Global_with_z (the edge2face single-image G, reference:
    models/networks.py:421-468): model_downsample, model_resnet,
    model_upsample, model_upsample_conv -> the JAX GlobalWithFeatures."""
    out: list[Triple] = list(_stem("model_downsample", 0, ("ConvStem_0",), norm))
    for i in range(n_downsampling):
        idx = 4 + 3 * i
        out += _conv(f"model_downsample.{idx}", (f"DownBlock_{i}", "Conv_0"))
        out += _norm(
            f"model_downsample.{idx + 1}", (f"DownBlock_{i}", "Norm_0"), norm
        )
    for k in range(n_blocks):
        out += _resblock(f"model_resnet.{k}", (f"ResnetBlock_{k}",), norm)
    for i in range(n_downsampling):
        out += _convT(
            f"model_upsample.{3 * i}", (f"UpBlock_{i}", "ConvTranspose_0")
        )
        out += _norm(
            f"model_upsample.{3 * i + 1}", (f"UpBlock_{i}", "Norm_0"), norm
        )
    out += _conv("model_upsample_conv.1", ("TanhHead_0", "Conv_0"))
    return out


def encoder_mapping(
    n_downsampling: int = 4, norm: str = "instance"
) -> list[Triple]:
    """Encoder netE (reference: models/networks.py:595-615): one `model`
    Sequential — stem, nd downs, nd ups, tanh head — -> the JAX Encoder."""
    out: list[Triple] = list(_stem("model", 0, ("ConvStem_0",), norm))
    idx = 4
    for i in range(n_downsampling):
        out += _conv(f"model.{idx}", (f"DownBlock_{i}", "Conv_0"))
        out += _norm(f"model.{idx + 1}", (f"DownBlock_{i}", "Norm_0"), norm)
        idx += 3
    for i in range(n_downsampling):
        out += _convT(f"model.{idx}", (f"UpBlock_{i}", "ConvTranspose_0"))
        out += _norm(f"model.{idx + 1}", (f"UpBlock_{i}", "Norm_0"), norm)
        idx += 3
    out += _conv(f"model.{idx + 1}", ("TanhHead_0", "Conv_0"))
    return out


# ---------------------------------------------------------- discriminators


def nlayer_discriminator_mapping(
    n_layers: int = 3, norm: str = "batch", prefix: str = "", fprefix: tuple = (),
) -> list[Triple]:
    """NLayerDiscriminator with intermediate features: Sequential groups
    `{prefix}{n}` (`model{n}` without a prefix)."""
    out: list[Triple] = []

    def group(n):
        return f"{prefix}{n}" if prefix else f"model{n}"

    out += _conv(f"{group(0)}.0", (*fprefix, "block0_conv"))
    for n in range(1, n_layers):
        out += _conv(f"{group(n)}.0", (*fprefix, f"block{n}_conv"))
        out += _norm(f"{group(n)}.1", (*fprefix, f"block{n}_norm"), norm)
    out += _conv(f"{group(n_layers)}.0", (*fprefix, f"block{n_layers}_conv"))
    out += _norm(f"{group(n_layers)}.1", (*fprefix, f"block{n_layers}_norm"), norm)
    out += _conv(f"{group(n_layers + 1)}.0", (*fprefix, "head_conv"))
    return out


def multiscale_discriminator_mapping(
    num_d: int = 2, n_layers: int = 3, norm: str = "batch",
) -> list[Triple]:
    out: list[Triple] = []
    for d in range(num_d):
        out += nlayer_discriminator_mapping(
            n_layers, norm, prefix=f"scale{d}_layer", fprefix=(f"scale{d}",),
        )
    return out


# --------------------------------------------------------------- flownet2


def _fn_conv(tkey: str, fpath: tuple) -> Iterator[Triple]:
    """flownet conv(): Sequential [conv, leaky] -> the JAX ConvL."""
    yield from _conv(f"{tkey}.0", (*fpath, "Conv_0"))


def _fn_deconv(tkey: str, fpath: tuple) -> Iterator[Triple]:
    """flownet deconv(): Sequential [convT, leaky] -> the JAX Deconv."""
    yield from _convT(f"{tkey}.0", (*fpath, "ConvTranspose_0"))


def flownet_c_mapping(prefix: str = "flownetc") -> list[Triple]:
    p = (prefix,)
    out: list[Triple] = []
    for name in ("conv1", "conv2", "conv3", "conv_redir"):
        out += _fn_conv(f"{prefix}.{name}", (*p, name))
    for name in ("conv3_1", "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"):
        out += _fn_conv(f"{prefix}.{name}", (*p, "enc", name))
    out += _decoder_mapping(prefix, (*p, "dec"), upflow_bias=True)
    return out


def flownet_s_mapping(prefix: str) -> list[Triple]:
    p = (prefix,)
    out: list[Triple] = []
    for name in ("conv1", "conv2", "conv3"):
        out += _fn_conv(f"{prefix}.{name}", (*p, name))
    for name in ("conv3_1", "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"):
        out += _fn_conv(f"{prefix}.{name}", (*p, "enc", name))
    out += _decoder_mapping(prefix, (*p, "dec"), upflow_bias=False)
    return out


def _decoder_mapping(prefix: str, fpath: tuple, upflow_bias: bool) -> list[Triple]:
    out: list[Triple] = []
    for lvl in (6, 5, 4, 3, 2):
        out += _conv(
            f"{prefix}.predict_flow{lvl}", (*fpath, f"predict_flow{lvl}", "Conv_0")
        )
    for lvl in (6, 5, 4, 3):
        out += _convT(
            f"{prefix}.upsampled_flow{lvl}_to_{lvl - 1}",
            (*fpath, f"upflow{lvl}", "ConvTranspose_0"),
            bias=upflow_bias,
        )
    for lvl in (5, 4, 3, 2):
        out += _fn_deconv(f"{prefix}.deconv{lvl}", (*fpath, f"deconv{lvl}"))
    return out


def flownet_sd_mapping(prefix: str = "flownets_d") -> list[Triple]:
    p = (prefix,)
    out: list[Triple] = []
    convs = [
        "conv0", "conv1", "conv1_1", "conv2", "conv2_1", "conv3", "conv3_1",
        "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1",
    ]
    for name in convs:
        out += _fn_conv(f"{prefix}.{name}", (*p, name))
    for lvl in (6, 5, 4, 3, 2):
        out += _conv(
            f"{prefix}.predict_flow{lvl}", (*p, f"predict_flow{lvl}", "Conv_0")
        )
    for lvl in (6, 5, 4, 3):
        out += _convT(
            f"{prefix}.upsampled_flow{lvl}_to_{lvl - 1}",
            (*p, f"upflow{lvl}", "ConvTranspose_0"),
        )
    for lvl in (5, 4, 3, 2):
        out += _fn_deconv(f"{prefix}.deconv{lvl}", (*p, f"deconv{lvl}"))
    for lvl in (5, 4, 3, 2):
        out += _conv(f"{prefix}.inter_conv{lvl}.0", (*p, f"inter_conv{lvl}", "Conv_0"))
    return out


def flownet_fusion_mapping(prefix: str = "flownetfusion") -> list[Triple]:
    p = (prefix,)
    out: list[Triple] = []
    for name in ("conv0", "conv1", "conv1_1", "conv2", "conv2_1"):
        out += _fn_conv(f"{prefix}.{name}", (*p, name))
    for lvl in (2, 1, 0):
        out += _conv(
            f"{prefix}.predict_flow{lvl}", (*p, f"predict_flow{lvl}", "Conv_0")
        )
    for lvl in (2, 1):
        out += _convT(
            f"{prefix}.upsampled_flow{lvl}_to_{lvl - 1}",
            (*p, f"upflow{lvl}", "ConvTranspose_0"),
        )
    for lvl in (1, 0):
        out += _fn_deconv(f"{prefix}.deconv{lvl}", (*p, f"deconv{lvl}"))
    for lvl in (1, 0):
        out += _conv(f"{prefix}.inter_conv{lvl}.0", (*p, f"inter_conv{lvl}", "Conv_0"))
    return out


def flownet2_mapping() -> list[Triple]:
    return (
        flownet_c_mapping("flownetc")
        + flownet_s_mapping("flownets_1")
        + flownet_s_mapping("flownets_2")
        + flownet_sd_mapping("flownets_d")
        + flownet_fusion_mapping("flownetfusion")
    )


# ------------------------------------------------------------------- vgg


def vgg19_mapping() -> list[Triple]:
    """torchvision vgg19 `features.{i}` conv indices -> conv{s}_{j} names."""
    torch_idx = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
    names = [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3", "conv3_4",
        "conv4_1", "conv4_2", "conv4_3", "conv4_4",
        "conv5_1",
    ]
    out: list[Triple] = []
    for idx, name in zip(torch_idx, names):
        out.append((f"features.{idx}.weight", ("params", name, "kernel"), "conv"))
        out.append((f"features.{idx}.bias", ("params", name, "bias"), "copy"))
    return out
