"""The serving artifact of the streaming generator, through torch.export.

Packages the one-frame inference step, (label window, instance window,
recurrent state) -> (frame, next state), with its weights, so that a
serving process runs the model without its Python definition (the port of
vid2vid_tpu/tools/export.py; reference: test.py:15-54,
vid2vid_model_G.py:198-229).

    # build and save (on the card; --gpu_ids -1 for the CPU)
    python -m vid2vid_tpu_torch.tools.export --name label2city_512 \
        --label_nc 35 --loadSize 512 --out exported/label2city_512

    # load and serve, on the device it was exported for
    from vid2vid_tpu_torch.tools.export import load_exported
    step = load_exported("exported/label2city_512", "cuda")
    frame, state = step(labels_window, inst_window, state)  # state=None first

The artifact directory holds:
  step.pt2   - torch.export.save of the step's ExportedProgram: the graph
               (ATen operators and the port's kernels as the operators
               torch.ops.v2v.respair / conv7 / warp_blend, ops/library.py),
               its input and output specs, and its weights;
  state0.pt  - the initial state (zero frames), a tuple of tensors;
  meta.json  - batch, height, width, n_frames_G, the counts of weight and
               state tensors, the state's dtypes, the device.
The JAX artifact is step.hlo + params.npz + state0.npz: jax.export
serializes a function, and its parameters travel beside it. An
ExportedProgram holds its weights (the state_dict and the constants), so
one file carries both. The weights are the engine's compute-dtype copy of
the generator (bf16 under --bf16); the eval layers' kernel arguments (the
folded norm affines and, on the card, the packed tensor-core weights;
nn/layers.py::eval_cached) enter the graph as constants, filled by one
eager step before the export, so the served step never re-packs them.
Shapes are static, as in JAX. The state keeps the initial state's dtypes
(the compute dtype); the frame is float32. A step exported on the card runs
on the card: `load_exported` raises on another device.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.ops.library import served_ops
from vid2vid_tpu_torch.utils.device import require_device

FILES = ("step.pt2", "state0.pt", "meta.json")
LABEL_DTYPE = torch.int64


class ExportStep(nn.Module):
    """`InferenceEngine.step` as a module of fixed signature: (labels
    (B, tG, H, W), inst (B, tG, H, W), *state) -> (frame (B, 3, H, W) f32,
    *new state in the given state's dtypes)."""

    def __init__(self, gen: Vid2VidGenerator, use_instance: bool, dtype: torch.dtype):
        super().__init__()
        self.gen = gen
        self.use_instance = use_instance
        self.dtype = dtype

    def forward(self, labels, inst, *state):
        enc = self.gen.encode_input(labels, inst if self.use_instance else None)
        outs, new_state = self.gen.generate_clip(
            enc.to(self.dtype), tuple(s.to(self.dtype) for s in state))
        return (outs.fake[:, 0].float(),
                *(n.to(s.dtype) for n, s in zip(new_state, state)))


def _engine(opt: Options, gen_or_engine) -> InferenceEngine:
    if isinstance(gen_or_engine, InferenceEngine):
        return gen_or_engine
    eng = InferenceEngine(opt, device=next(gen_or_engine.parameters()).device)
    eng.load_state_dict(gen_or_engine.state_dict())
    return eng


def build_exported(opt: Options, gen_or_engine, batch: int, height: int, width: int):
    """torch.export the one-frame step on the engine's device (an
    InferenceEngine, or a Vid2VidGenerator of master weights); returns
    (ExportedProgram, state0)."""
    eng = _engine(opt, gen_or_engine)
    state0 = eng.initial_state(batch, height, width)
    # two tensors: an input passed twice is traced as one
    labels, inst = (torch.zeros((batch, opt.n_frames_G, height, width), dtype=LABEL_DTYPE,
                                device=eng.device) for _ in range(2))
    args = (labels, inst, *state0)
    module = ExportStep(eng.compute_generator(), opt.use_instance, eng.compute_dtype)
    with torch.no_grad():
        module(*args)  # fills the eval caches that the trace reads as constants
        exported = torch.export.export(module, args, strict=False)
    return exported, state0


def save_exported(out_dir: str, opt: Options, gen_or_engine, batch: int, height: int,
                  width: int) -> torch.export.ExportedProgram:
    """Write the artifact (FILES) to out_dir; returns the exported program."""
    exported, state0 = build_exported(opt, gen_or_engine, batch, height, width)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, "step.pt2"))
    torch.save(tuple(state0), os.path.join(out_dir, "state0.pt"))
    meta = {
        "n_params": len(exported.state_dict) + len(exported.constants),
        "n_state": len(state0),
        "batch": batch,
        "height": height,
        "width": width,
        "n_frames_G": opt.n_frames_G,
        "state_dtypes": [str(s.dtype) for s in state0],
        "device": state0[0].device.type,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
    return exported


def _lifted_call(program: torch.export.ExportedProgram):
    """A function calling the program's graph with its weights (parameters,
    buffers, constants) as leading arguments, in the order of its input
    specs. `program.module()` looks each weight up through the module tree
    on every call, one nested attribute read a weight, which holds the
    card idle for the host's time before the step's first kernel."""
    from torch.export.graph_signature import InputKind, OutputKind

    sig = program.graph_signature
    weights, n_user = [], 0
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            n_user += 1
            continue
        if n_user or spec.kind not in (InputKind.PARAMETER, InputKind.BUFFER,
                                       InputKind.CONSTANT_TENSOR):
            raise ValueError(f"unexpected input {spec} in the exported step")
        held = (program.state_dict if spec.kind == InputKind.PARAMETER
                or (spec.kind == InputKind.BUFFER and spec.persistent) else program.constants)
        weights.append(held[spec.target])
    if any(spec.kind != OutputKind.USER_OUTPUT for spec in sig.output_specs):
        raise ValueError("the exported step mutates its inputs")
    graph = program.graph_module
    return lambda *args: graph(*weights, *args)


def load_exported(out_dir: str, device: torch.device | str = "cuda"):
    """Rebuild the serving step from an artifact directory on `device`, the
    device type it was exported for (raises otherwise, and for CUDA without
    a card).

    Returns `step(labels_window, inst_window, state=None) -> (frame, state)`
    where state is an opaque tuple carried between calls (None resets).
    """
    dev = require_device(device)
    with open(os.path.join(out_dir, "meta.json")) as fh:
        meta = json.load(fh)
    if meta["device"] != dev.type:
        raise ValueError(f"{out_dir} was exported for {meta['device']}, not {dev.type}")
    served_ops()  # the graph calls torch.ops.v2v.*: define them before loading
    program = _lifted_call(torch.export.load(os.path.join(out_dir, "step.pt2")))
    state0 = tuple(s.to(dev) for s in torch.load(os.path.join(out_dir, "state0.pt"),
                                                 map_location=dev, weights_only=True))
    window = (meta["batch"], meta["n_frames_G"], meta["height"], meta["width"])

    @torch.no_grad()
    def step(labels_window, inst_window, state=None):
        labels, inst = (torch.as_tensor(x).to(dev, LABEL_DTYPE)
                        for x in (labels_window, inst_window))
        if tuple(labels.shape) != window or tuple(inst.shape) != window:
            raise ValueError(f"windows {tuple(labels.shape)}, {tuple(inst.shape)}: the "
                             f"artifact takes {window}")
        outs = program(labels, inst, *(state0 if state is None else state))
        return outs[0], tuple(outs[1:])

    return step


def main(argv=None) -> None:
    import argparse
    import sys

    from vid2vid_tpu_torch.config import parse_args
    from vid2vid_tpu_torch.test_cli import load_weights

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    own, rest = ap.parse_known_args(argv)
    opt = parse_args(rest, is_train=False, save=False)
    out = own.out or os.path.join("exported", opt.name)
    width = own.width or opt.loadSize
    height = own.height or width // 2

    eng = InferenceEngine(opt, device="cuda" if opt.gpu_ids else "cpu")
    load_weights(opt, eng)  # warns and seeds the weights when there is no checkpoint
    save_exported(out, opt, eng, own.batch, height, width)
    print(f"exported serving artifact -> {out}")


if __name__ == "__main__":
    main()
