"""Carry weights from the JAX package into the port.

The name mappings (`utils/mappings.py`, the port's copy of the JAX
package's checkpoint-import mappings) pair each reference state-dict key
with a path of the JAX package's flax variable tree.
`jax_variables_to_state_dict` runs those mappings backwards: it takes a JAX
`{params, batch_stats}` tree (numpy arrays) and returns the port's
state_dict, which `load_state_dict(strict=True)` accepts. Nothing here
imports the JAX package: the trees arrive as nested dicts of arrays.

Inverse layout conversions:
  conv:  HWIO -> OIHW;
  convT: (kH, kW, I, O) -> (I, O, kH, kW);
  concat_conv / concat_copy: the JAX flow+weight head `final_fw` (3 output
  channels) splits into model_final_flow (2) and model_final_w (1).
Every norm with running stats also gets `num_batches_tracked = 0`.

`train_state_checkpoint` turns a JAX train-state payload (the dict
vid2vid_tpu/train/checkpoints.py::save_checkpoint writes: gparams, dparams,
opt_g, opt_d, opt_dt, schedule) into the port's checkpoint files
(train/checkpoints.py): optax's Adam moments `mu` / `nu` and `count` become
torch Adam's `exp_avg` / `exp_avg_sq` and `step`, through the weights'
mappings (the D group's over D and, under --add_face_disc, D_f), so a run
the JAX CLI trained resumes in the port's CLI.

The JAX package has no checkpoint mapping for LocalEnhancer and
LocalWithFeatures (no published single-image checkpoint uses them in its
registry); `local_enhancer_mapping` and `local_with_features_mapping` pair
the port's names (nn/pix2pixhd.py) with the JAX modules' paths.
"""

from __future__ import annotations

import numpy as np
import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.models.loss_engine import LossEngine
from vid2vid_tpu_torch.train.checkpoints import SCHEDULE_FIELDS
from vid2vid_tpu_torch.train.state import create_train_state
from vid2vid_tpu_torch.utils.mappings import (
    Triple,
    _conv,
    _convT,
    _norm,
    _resblock,
    _stem,
    composite_generator_mapping,
    composite_local_mapping,
    encoder_mapping,
    flownet2_mapping,
    flownet_c_mapping,
    flownet_fusion_mapping,
    flownet_s_mapping,
    flownet_sd_mapping,
    global_generator_mapping,
    global_with_features_mapping,
    multiscale_discriminator_mapping,
    vgg19_mapping,
)

_FLOWNET_MAPPINGS = {
    "FlowNetC": flownet_c_mapping,
    "FlowNetS": flownet_s_mapping,
    "FlowNetSD": flownet_sd_mapping,
    "FlowNetFusion": flownet_fusion_mapping,
}

# output channels of the keys that the JAX package concatenates
_CONCAT_WIDTHS = {"model_final_flow": 2, "model_final_w": 1}


def _leaf(tree: dict, path: tuple):
    node = tree
    for part in path:
        node = node[part]
    return np.asarray(node)


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "convT":
        return np.transpose(arr, (2, 3, 0, 1))
    return arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr))  # a copy, never a view


def jax_variables_to_state_dict(variables: dict, mapping: list) -> dict:
    """JAX {params, batch_stats} tree + a torch_import mapping -> state_dict."""
    out: dict[str, torch.Tensor] = {}
    for tkey, fpath, kind in mapping:
        arr = _leaf(variables, fpath)
        if isinstance(tkey, tuple):
            base_kind = kind.split("_")[1]  # concat_conv -> conv
            widths = [_CONCAT_WIDTHS[k.split(".")[0]] for k in tkey]
            if sum(widths) != arr.shape[-1]:
                raise ValueError(f"{fpath}: {arr.shape} does not split as {widths}")
            parts = np.split(arr, np.cumsum(widths)[:-1], axis=-1)
            for k, part in zip(tkey, parts):
                out[k] = _tensor(_to_torch_layout(part, base_kind))
        else:
            out[tkey] = _tensor(_to_torch_layout(arr, kind))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def generator_mappings(opt: Options) -> list[list]:
    """The torch_import mapping of each scale G0..G{n-1} for `opt`."""
    no_flow = opt.effective_no_flow
    maps = [
        composite_generator_mapping(
            opt.n_downsample_G, opt.n_blocks, opt.norm, opt.fg, no_flow
        )
    ]
    for _ in range(1, opt.n_scales_spatial):
        maps.append(
            composite_local_mapping(opt.n_blocks_local, opt.norm, opt.fg, no_flow)
        )
    return maps


def generator_state_dict(params: dict, opt: Options) -> dict:
    """JAX Vid2VidGenerator params {'G0': vars, ...} -> the port's
    Vid2VidGenerator state_dict (keys prefixed G{s}.)."""
    out = {}
    for s, mapping in enumerate(generator_mappings(opt)):
        sd = jax_variables_to_state_dict(params[f"G{s}"], mapping)
        out.update({f"G{s}.{k}": v for k, v in sd.items()})
    return out


def flownet_mapping(name: str) -> list:
    """The torch_import mapping of one standalone flow net ('FlowNetC',
    'FlowNetS', 'FlowNetSD' or 'FlowNetFusion'): the reference's keys and
    the flax paths of the net on its own, without FlowNet2's prefix."""
    raw = _FLOWNET_MAPPINGS[name]("_")
    return [(key[2:], (path[0],) + path[2:], kind) for key, path, kind in raw]


def flownet_state_dict(variables: dict, name: str) -> dict:
    """JAX variables of one standalone flow net -> the port's state_dict."""
    return jax_variables_to_state_dict(variables, flownet_mapping(name))


def flownet2_state_dict(variables: dict) -> dict:
    """JAX FlowNet2 variables -> the port's FlowNet2 state_dict."""
    return jax_variables_to_state_dict(variables, flownet2_mapping())


def face_discriminator_mapping(opt: Options) -> list:
    """The mapping of the face discriminator: max(1, num_D - 2) scales."""
    return multiscale_discriminator_mapping(max(1, opt.num_D - 2), opt.n_layers_D, opt.norm)


def loss_engine_state_dict(dparams: dict, opt: Options) -> dict:
    """JAX LossEngine params {'D', ['D_f'], 'D_T{s}', 'vgg'} -> the port's
    LossEngine state_dict (keys netD., netD_f., netD_T.{s}. and vgg.)."""
    d_map = multiscale_discriminator_mapping(opt.num_D, opt.n_layers_D, opt.norm)
    out = {}
    groups = [("D", "netD", d_map)] + [
        (f"D_T{s}", f"netD_T.{s}", d_map) for s in range(opt.n_scales_temporal)
    ]
    if opt.add_face_disc:
        groups.append(("D_f", "netD_f", face_discriminator_mapping(opt)))
    if not opt.no_vgg:
        groups.append(("vgg", "vgg", vgg19_mapping()))
    for key, prefix, mapping in groups:
        sd = jax_variables_to_state_dict(dparams[key], mapping)
        out.update({f"{prefix}.{k}": v for k, v in sd.items()})
    return out


# ------------------------------------------------------------ train state


def _fields(node) -> dict | None:
    """The children of a node of an optax state: a NamedTuple's fields, a
    dict's items, a sequence's entries; None for a leaf."""
    if hasattr(node, "_asdict"):
        return node._asdict()
    if isinstance(node, dict):
        return node
    if isinstance(node, (list, tuple)):
        return dict(enumerate(node))
    return None


def _find(node, keys: set) -> dict | None:
    """The first node, depth first, whose children include every key."""
    fields = _fields(node)
    if fields is None:
        return None
    if keys <= fields.keys():
        return fields
    for child in fields.values():
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def _adam_state_dict(opt_state, template: dict, names: list[str], to_sd) -> dict:
    """An optax inject_hyperparams(adam) state -> torch Adam's state_dict.
    `template` is the torch optimizer's own state_dict (its param_groups),
    `names` its parameters' state-dict keys in order, `to_sd` maps a tree
    shaped like the weights to a state_dict."""
    adam = _find(opt_state, {"mu", "nu", "count"})
    hyper = _find(opt_state, {"learning_rate"})
    if adam is None or hyper is None:
        raise ValueError("not an optax inject_hyperparams(adam) state")
    mu, nu = to_sd(adam["mu"]), to_sd(adam["nu"])
    step = float(np.asarray(adam["count"]))
    groups = [dict(g) for g in template["param_groups"]]
    for g in groups:
        g["lr"] = float(np.asarray(hyper["learning_rate"]))
    state = {
        i: {"step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, n in enumerate(names)
    }
    return {"state": state, "param_groups": groups}


def train_state_checkpoint(payload: dict, opt: Options) -> dict:
    """A JAX train-state payload (numpy leaves; optax states as NamedTuples
    or as nested dicts / lists) -> the port's checkpoint files, as
    train/checkpoints.py::checkpoint_payloads returns them (write them with
    write_checkpoint)."""
    with torch.device("meta"):  # the modules only name and order the parameters
        gen, engine = Vid2VidGenerator(opt), LossEngine(opt)
    state = create_train_state(opt, gen, engine)
    d_map = multiscale_discriminator_mapping(opt.num_D, opt.n_layers_D, opt.norm)

    def d_sd(tree):
        return jax_variables_to_state_dict(tree, d_map)

    def df_sd(tree):
        return jax_variables_to_state_dict(tree, face_discriminator_mapping(opt))

    def d_group_sd(tree):  # the D optimizer's group: netD's and netD_f's moments
        fields = _fields(tree)
        out = {f"netD.{k}": v for k, v in d_sd(fields["D"]).items()}
        if opt.add_face_disc:
            out.update({f"netD_f.{k}": v for k, v in df_sd(fields["D_f"]).items()})
        return out

    def g_sd(tree):
        return generator_state_dict(tree, opt)

    def names(net):
        return [n for n, _ in net.named_parameters()]

    g_weights = g_sd(payload["gparams"])
    files = {
        f"net_G{s}": {k[len(f"G{s}."):]: v for k, v in g_weights.items()
                      if k.startswith(f"G{s}.")}
        for s in range(opt.n_scales_spatial)
    }
    files["net_D"] = d_sd(payload["dparams"]["D"])
    if opt.add_face_disc:
        files["net_D_f"] = df_sd(payload["dparams"]["D_f"])
    for s in range(opt.n_scales_temporal):
        files[f"net_D_T{s}"] = d_sd(payload["dparams"][f"D_T{s}"])
    files["optim"] = {
        "opt_g": _adam_state_dict(payload["opt_g"], state.opt_g.state_dict(),
                                  names(gen), g_sd),
        "opt_d": _adam_state_dict(
            payload["opt_d"], state.opt_d.state_dict(),
            [f"netD.{n}" for n in names(engine.netD)]
            + ([f"netD_f.{n}" for n in names(engine.netD_f)] if opt.add_face_disc else []),
            d_group_sd),
        "opt_dt": [
            _adam_state_dict(o, state.opt_dt[s].state_dict(), names(engine.netD_T[s]), d_sd)
            for s, o in enumerate(payload["opt_dt"])
        ],
        "schedule": {f: np.asarray(payload["schedule"][f]).item() for f in SCHEDULE_FIELDS},
    }
    return files


# ------------------------------------------------------------- pix2pixHD


def _enhancer_mapping(n: int, n_blocks_local: int, norm: str) -> list[Triple]:
    """`model{n}_1` (stem + down) and `model{n}_2`'s resblocks and up block
    -> the JAX enh{n}_* modules."""
    out: list[Triple] = list(_stem(f"model{n}_1", 0, (f"enh{n}_stem",), norm))
    out += _conv(f"model{n}_1.4", (f"enh{n}_down", "Conv_0"))
    out += _norm(f"model{n}_1.5", (f"enh{n}_down", "Norm_0"), norm)
    for i in range(n_blocks_local):
        out += _resblock(f"model{n}_2.{i}", (f"enh{n}_res{i}",), norm)
    out += _convT(f"model{n}_2.{n_blocks_local}", (f"enh{n}_up", "ConvTranspose_0"))
    out += _norm(f"model{n}_2.{n_blocks_local + 1}", (f"enh{n}_up", "Norm_0"), norm)
    return out


def local_enhancer_mapping(
    n_downsample_global: int = 3, n_blocks_global: int = 9,
    n_local_enhancers: int = 1, n_blocks_local: int = 3, norm: str = "instance",
) -> list[Triple]:
    """pix2pixHD's LocalEnhancer names -> the JAX LocalEnhancer: `model`
    (GlobalGenerator's without the head) -> global, `model{n}_1` /
    `model{n}_2` -> enh{n}_*, the head at the end of the last `model{n}_2`
    -> final."""
    out: list[Triple] = [
        (key, (path[0], "global", *path[1:]), kind)
        for key, path, kind in global_generator_mapping(n_downsample_global, n_blocks_global, norm)
        if "TanhHead_0" not in path
    ]
    for n in range(1, n_local_enhancers + 1):
        out += _enhancer_mapping(n, n_blocks_local, norm)
    out += _conv(f"model{n_local_enhancers}_2.{n_blocks_local + 4}", ("final", "Conv_0"))
    return out


def local_with_features_mapping(
    n_downsample_global: int = 3, n_blocks_global: int = 9,
    n_local_enhancers: int = 1, n_blocks_local: int = 3, norm: str = "instance",
) -> list[Triple]:
    """The port's LocalWithFeatures names -> the JAX LocalWithFeatures:
    model_downsample -> g_stem, g_down*; model_resnet -> g_res*;
    model_upsample -> g_up*; model{n}_1 / model{n}_2 -> enh{n}_*;
    model_final -> final."""
    out: list[Triple] = list(_stem("model_downsample", 0, ("g_stem",), norm))
    for i in range(n_downsample_global):
        out += _conv(f"model_downsample.{4 + 3 * i}", (f"g_down{i}", "Conv_0"))
        out += _norm(f"model_downsample.{5 + 3 * i}", (f"g_down{i}", "Norm_0"), norm)
    for k in range(n_blocks_global):
        out += _resblock(f"model_resnet.{k}", (f"g_res{k}",), norm)
    for i in range(n_downsample_global):
        out += _convT(f"model_upsample.{3 * i}", (f"g_up{i}", "ConvTranspose_0"))
        out += _norm(f"model_upsample.{3 * i + 1}", (f"g_up{i}", "Norm_0"), norm)
    for n in range(1, n_local_enhancers + 1):
        out += _enhancer_mapping(n, n_blocks_local, norm)
    out += _conv("model_final.1", ("final", "Conv_0"))
    return out


def single_g_mapping(
    kind: str, n_downsampling: int, n_blocks: int, norm: str = "instance",
    n_local_enhancers: int = 1, n_blocks_local: int = 3,
) -> list[Triple]:
    """The mapping of one single-image generator kind ('global', 'local',
    'global_with_features' or 'local_with_features'); n_downsampling and
    n_blocks are the global trunk's."""
    if kind == "global":
        return global_generator_mapping(n_downsampling, n_blocks, norm)
    if kind == "global_with_features":
        return global_with_features_mapping(n_downsampling, n_blocks, norm)
    local = {"local": local_enhancer_mapping,
             "local_with_features": local_with_features_mapping}
    if kind not in local:
        raise ValueError(f"no single-image generator kind {kind!r}")
    return local[kind](n_downsampling, n_blocks, n_local_enhancers, n_blocks_local, norm)


def single_g_state_dict(params: dict, kind: str, **dims) -> dict:
    """JAX single-image generator variables -> the port's state_dict
    (`dims` as single_g_mapping takes them)."""
    return jax_variables_to_state_dict(params, single_g_mapping(kind, **dims))


def encoder_state_dict(params: dict, n_downsampling: int = 4, norm: str = "instance") -> dict:
    """JAX Encoder variables -> the port's Encoder state_dict."""
    return jax_variables_to_state_dict(params, encoder_mapping(n_downsampling, norm))
