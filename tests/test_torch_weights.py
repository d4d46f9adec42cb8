"""Weights carried from the JAX package into the port and back.

JAX variables -> vid2vid_tpu_torch.utils.from_jax -> the port's state_dict
must load with strict=True (no missing, no unexpected keys), and the port's
state_dict run through the JAX package's own import mapping
(torch_import.apply_mapping) must give back the JAX tree leaf for leaf.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vid2vid_tpu.models.flownet2.nets as jax_flow_nets
from torch_parity import init_like, randomize
from vid2vid_tpu.config import Options
from vid2vid_tpu.models.flownet2.flownet2 import FlowNet2 as JaxFlowNet2
from vid2vid_tpu.models.generator import Vid2VidGenerator as JaxGenerator
from vid2vid_tpu.utils.torch_import import apply_mapping, flownet2_mapping
from vid2vid_tpu_torch.models.flownet2 import nets as flow_nets
from vid2vid_tpu_torch.models.flownet2.flownet2 import FlowNet2
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.utils.from_jax import (
    flownet2_state_dict,
    flownet_mapping,
    flownet_state_dict,
    generator_mappings,
    generator_state_dict,
    jax_variables_to_state_dict,
)

BASE = dict(
    label_nc=4, use_instance=True, ngf=8, n_downsample_G=2, n_blocks=3,
    n_blocks_local=1, n_scales_spatial=2, n_frames_G=3, isTrain=False,
)
CONFIGS = {
    "fg-batch": dict(fg=True, fg_labels=(3,), norm="batch"),
    "noflow-batch": dict(no_flow=True, norm="batch"),
    "fg-instance-3scales": dict(fg=True, fg_labels=(3,), norm="instance",
                                n_scales_spatial=3, n_downsample_G=3),
}


def _opt(name: str) -> Options:
    return Options(**{**BASE, **CONFIGS[name]})


@pytest.fixture(scope="module")
def jax_params():
    """JAX generator params per config name, initialised once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            gen = JaxGenerator(_opt(name))
            params = jax.jit(lambda k: gen.init(k, 1, 32, 64))(jax.random.key(0))
            rng = np.random.default_rng(len(cache))
            cache[name] = {g: randomize(v, rng) for g, v in params.items()}
        return cache[name]

    return get


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_strict_load_and_round_trip(jax_params, name):
    opt = _opt(name)
    params = jax_params(name)
    port = Vid2VidGenerator(opt)
    sd = generator_state_dict(params, opt)
    assert set(sd) == set(port.state_dict())
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys

    for s, mapping in enumerate(generator_mappings(opt)):
        prefix = f"G{s}."
        torch_sd = {k[len(prefix):]: v.numpy() for k, v in port.state_dict().items()
                    if k.startswith(prefix)}
        back = dict(_leaves(apply_mapping(torch_sd, mapping)))
        want = dict(_leaves(params[f"G{s}"]))
        assert set(back) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_flow_and_weight_heads_split(jax_params):
    opt = _opt("fg-batch")
    params = jax_params("fg-batch")
    fw = np.asarray(params["G0"]["params"]["heads"]["final_fw_kernel"])  # HWIO
    sd = generator_state_dict(params, opt)
    flow, w = sd["G0.model_final_flow.1.weight"], sd["G0.model_final_w.1.weight"]
    assert tuple(flow.shape) == (2, opt.ngf, 7, 7) and tuple(w.shape) == (1, opt.ngf, 7, 7)
    np.testing.assert_array_equal(w.numpy(), np.transpose(fw[..., 2:], (3, 2, 0, 1)))
    bias = np.asarray(params["G0"]["params"]["heads"]["final_fw_bias"])
    np.testing.assert_array_equal(sd["G0.model_final_flow.1.bias"].numpy(), bias[:2])


def test_conversion_layouts():
    hwio = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    variables = {"params": {"c": {"kernel": hwio}, "t": {"kernel": hwio}}}
    mapping = [("conv.weight", ("params", "c", "kernel"), "conv"),
               ("convT.weight", ("params", "t", "kernel"), "convT")]
    sd = jax_variables_to_state_dict(variables, mapping)
    assert tuple(sd["conv.weight"].shape) == (5, 4, 2, 3)    # OIHW
    assert tuple(sd["convT.weight"].shape) == (4, 5, 2, 3)   # (I, O, kH, kW)
    assert sd["conv.weight"][1, 2, 0, 1] == hwio[0, 1, 2, 1]
    assert sd["convT.weight"][2, 1, 0, 1] == hwio[0, 1, 2, 1]


def _jax_variables(module, *inputs, seed=0):
    """Variables in the tree of `module`'s flax init, drawn with numpy."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *inputs)
    rng = np.random.default_rng(seed)
    return randomize(init_like(shapes, rng), rng)


def _round_trip(port, variables, mapping):
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = dict(_leaves(apply_mapping(sd, mapping)))
    want = dict(_leaves(variables))
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_flownet2_strict_load_and_round_trip():
    z = jnp.zeros((1, 64, 64, 3))
    variables = _jax_variables(JaxFlowNet2(), z, z)
    port = FlowNet2()
    sd = flownet2_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert sum(p.numel() for p in port.parameters()) == 162_518_834
    _round_trip(port, variables, flownet2_mapping())
    # FlowNetS has no bias on its learned flow upsampling; C, SD, Fusion do
    assert port.flownets_1.upsampled_flow6_to_5.bias is None
    assert port.flownetc.upsampled_flow6_to_5.bias is not None


@pytest.mark.parametrize(
    "name,in_ch", [("FlowNetC", 6), ("FlowNetS", 6), ("FlowNetSD", 6), ("FlowNetFusion", 11)]
)
def test_standalone_flow_net_load_and_round_trip(name, in_ch):
    variables = _jax_variables(getattr(jax_flow_nets, name)(), jnp.zeros((1, 64, 64, in_ch)))
    kwargs = {} if name == "FlowNetC" else {"input_channels": in_ch}
    port = getattr(flow_nets, name)(**kwargs)
    result = port.load_state_dict(flownet_state_dict(variables, name), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    _round_trip(port, variables, flownet_mapping(name))
