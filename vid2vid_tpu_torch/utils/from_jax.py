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
"""

from __future__ import annotations

import numpy as np
import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.utils.mappings import (
    composite_generator_mapping,
    composite_local_mapping,
    flownet2_mapping,
    flownet_c_mapping,
    flownet_fusion_mapping,
    flownet_s_mapping,
    flownet_sd_mapping,
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


def loss_engine_state_dict(dparams: dict, opt: Options) -> dict:
    """JAX LossEngine params {'D', 'D_T{s}', 'vgg'} -> the port's LossEngine
    state_dict (keys netD., netD_T.{s}. and vgg.)."""
    d_map = multiscale_discriminator_mapping(opt.num_D, opt.n_layers_D, opt.norm)
    out = {}
    groups = [("D", "netD", d_map)] + [
        (f"D_T{s}", f"netD_T.{s}", d_map) for s in range(opt.n_scales_temporal)
    ]
    if not opt.no_vgg:
        groups.append(("vgg", "vgg", vgg19_mapping()))
    for key, prefix, mapping in groups:
        sd = jax_variables_to_state_dict(dparams[key], mapping)
        out.update({f"{prefix}.{k}": v for k, v in sd.items()})
    return out
