"""Seeded weights and batch-norm statistics, made on the device.

One dict of tensors, keyed by the reference's state-dict names, drawn
from `--seed` with a torch.Generator on the device in one normal draw for
the whole model, cut into views and scaled per tensor. The same dict
loads into the plain reference and into the program, which copies it
into its own parameters.

The draws (the configurations' `assumed`): conv weights He-normal,
N(0, 2 / fan_in); the 7x7 heads' at HEAD_GAIN and the flow head's at
FLOW_GAIN of that scale, so that tanh and sigmoid stay off saturation and
flows are a few pixels; conv biases, batch-norm shifts N(0, 0.1^2), scales
1 + N(0, 0.1^2), both at PREV_GAIN of that in the previous-frame trunks
(`model_down_img`), whose output they scale whatever the statistics: the
frame-to-frame map then contracts, as a trained model's does, and a
rounding made in one frame fades in the next ones.

The running statistics are not drawn but measured (`calibrate_norms`),
as training leaves them: with statistics that do not match the
activations, eval-mode batch norm normalises nothing, each ResnetBlock
adds about its input's variance again, and at the flagship's depth the
frames saturate and the frame-to-frame map turns chaotic (an f32
rounding grew tenfold a frame, to a 20-40% gap by the sixth frame).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from portbench.streets import street_sequence

HEAD_GAIN = 0.7  # std of a head's pre-activation relative to He's
FLOW_GAIN = 0.005
PREV_GAIN = 0.1  # the previous-frame trunk's batch-norm scales and shifts
CALIBRATION_FRAMES = 3
VAR_FLOOR = 1e-2  # a channel that was constant in the calibration frames


def _conv_std(name: str, w: torch.Tensor, transposed: bool) -> float:
    if transposed:  # (cin, cout, k, k), stride 2: a quarter of the taps land
        fan_in = w.shape[0] * w.shape[2] * w.shape[3] / 4
    else:
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(2.0 / fan_in)
    if ".model_final_flow." in name:
        return FLOW_GAIN * std / math.sqrt(2.0)
    if ".model_final_" in name or ".indv_final." in name:
        return HEAD_GAIN * std / math.sqrt(2.0)
    return std


def seeded_state(model: nn.Module, seed: int, device) -> dict:
    """{name: tensor} for every parameter and buffer of `model` (the
    reference, on any device), drawn from `seed` on `device` in f32; the
    running statistics start at mean 0 and variance 1."""
    kinds = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}"] = m
    sd = model.state_dict()
    params = [(k, v) for k, v in sd.items() if k in kinds]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(v.numel() for _, v in params), generator=gen, device=device)
    out, at = {}, 0
    for key, v in sd.items():
        leaf = key.rsplit(".", 1)[1]
        if key not in kinds:  # batch norm's buffers
            fill = {"running_mean": 0.0, "running_var": 1.0, "num_batches_tracked": 0}[leaf]
            out[key] = torch.full(v.shape, fill, dtype=v.dtype, device=device)
            continue
        z = normal[at : at + v.numel()].view(v.shape)
        at += v.numel()
        m = kinds[key]
        if isinstance(m, nn.BatchNorm2d):
            out[key] = (1.0 + 0.1 * z) if leaf == "weight" else 0.1 * z
            if ".model_down_img." in key:
                out[key] = out[key] * PREV_GAIN
        elif leaf == "weight":
            out[key] = z * _conv_std(key, v, isinstance(m, nn.ConvTranspose2d))
        else:  # a conv bias
            out[key] = 0.1 * z
    return out


@torch.no_grad()
def calibrate_norms(ref: nn.Module, state: dict, seed: int, height: int, width: int,
                    device) -> None:
    """Sets the running statistics in `state` (in place) to what the
    reference measures on the seed's own street frames at 1 / 8 of the
    cell's size (at least 64 rows): CALIBRATION_FRAMES frames from a zero
    state, batch norm in train mode, each frame's statistics replacing the
    last (the first frame's previous-frame trunk sees only zeros)."""
    f = max(1, min(8, height // 64))
    h, w = height // f, width // f
    rng = np.random.default_rng([seed, 2])
    labels, inst = street_sequence(rng, CALIBRATION_FRAMES + ref.tG - 1, h, w, 1.0, device)
    ref.load_state_dict(state, assign=True)  # the module's tensors are state's
    norms = [m for m in ref.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in norms:
        m.train()
        m.momentum = 1.0
    frames = ref.zero_state(1, h, w, device)
    for t in range(CALIBRATION_FRAMES):
        _, frames = ref.step(labels[None, t : t + ref.tG], inst[None, t : t + ref.tG], frames)
    for m in norms:
        m.running_var.clamp_(min=VAR_FLOOR)
        m.num_batches_tracked.zero_()
        m.momentum = 0.1
    ref.eval()
