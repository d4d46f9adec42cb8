"""Standalone flow-net CLI (the port of vid2vid_tpu/models/flownet2/main_cli.py;
the reference's flownet2_pytorch/main.py), inference mode.

Reflection-driven flags like the reference's `tools.add_arguments_for_module`
(flownet2_pytorch/utils/tools.py:55-86): every keyword argument of the
chosen model / inference dataset class is exposed as `--model_<kwarg>` /
`--inference_dataset_<kwarg>`. Only the flags that inference reads are
parsed; the training flags come with the training mode.

    python -m vid2vid_tpu_torch.models.flownet2.main_cli --inference \\
        --model FlowNetC --inference_dataset ImagesFromFolder \\
        --inference_dataset_root frames/ --save ./work --name run

writes <save>/<name>_inference/NNNNNN.flo, one per consecutive frame pair,
from the network's seeded initialisation (--seed). It runs on the first
CUDA device (`--device cuda`, the default; it raises without one) or, with
`--device cpu`, on the CPU; the datasets read images with PIL.
Training (no --inference) and --resume raise NotImplementedError: the
flow-net training harness is not ported yet.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys

import torch

from vid2vid_tpu_torch.models.flownet2 import datasets as flow_datasets
from vid2vid_tpu_torch.models.flownet2 import nets as flow_nets
from vid2vid_tpu_torch.models.flownet2.harness import TRAINING_NOT_PORTED, FlowHarness


def _class_registry(module):
    return {
        name: cls
        for name, cls in inspect.getmembers(module, inspect.isclass)
        if cls.__module__ == module.__name__ and not name.startswith("_")
    }


MODELS = {
    k: v for k, v in _class_registry(flow_nets).items() if k.startswith("FlowNet")
}
DATASETS = _class_registry(flow_datasets)


def add_arguments_for_module(parser, prefix: str, cls):
    """Expose `cls.__init__` keyword args as --<prefix>_<name> flags
    (reference: flownet2_pytorch/utils/tools.py:55-86)."""
    sig = inspect.signature(cls.__init__)
    for name, p in sig.parameters.items():
        if name == "self":
            continue
        default = None if p.default is inspect.Parameter.empty else p.default
        typ = type(default) if default is not None else str
        if typ is bool:
            parser.add_argument(
                f"--{prefix}_{name}", type=lambda s: s.lower() in ("1", "true"),
                default=default,
            )
        else:
            parser.add_argument(f"--{prefix}_{name}", type=typ, default=default)


def _kwargs_for(ns, prefix: str, cls):
    out = {}
    for name in inspect.signature(cls.__init__).parameters:
        if name == "self":
            continue
        v = getattr(ns, f"{prefix}_{name}", None)
        if v is not None:
            out[name] = v
    return out


def main(argv=None):
    # no abbreviations: "--inference" must not read as "--inference_dataset"
    pre = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    pre.add_argument("--model", default="FlowNetS", choices=sorted(MODELS))
    pre.add_argument("--inference_dataset", default="ImagesFromFolder",
                     choices=sorted(DATASETS))
    known, _ = pre.parse_known_args(argv)

    parser = argparse.ArgumentParser(parents=[pre], allow_abbrev=False)
    parser.add_argument("--div_flow", type=float, default=0.05)
    parser.add_argument("--save", default="./work")
    parser.add_argument("--name", default="run")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--inference", action="store_true")
    parser.add_argument("--resume", default="", choices=("", "latest", "best"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    add_arguments_for_module(parser, "model", MODELS[known.model])
    if "input_channels" in inspect.signature(MODELS[known.model].__init__).parameters:
        parser.set_defaults(model_input_channels=6)  # the stacked frame pair
    add_arguments_for_module(parser, "inference_dataset", DATASETS[known.inference_dataset])
    args = parser.parse_args(argv)

    if args.resume or not args.inference:
        raise NotImplementedError(TRAINING_NOT_PORTED)

    model_cls = MODELS[args.model]
    mkw = _kwargs_for(args, "model", model_cls)
    if "train_outputs" in inspect.signature(model_cls.__init__).parameters:
        mkw.setdefault("train_outputs", True)
    net = model_cls(**mkw)
    flow_nets.init_flownet_weights(net, torch.Generator().manual_seed(args.seed))
    harness = FlowHarness(net, div_flow=args.div_flow, device=args.device)

    ds_cls = DATASETS[args.inference_dataset]
    ds = ds_cls(**_kwargs_for(args, "inference_dataset", ds_cls))
    os.makedirs(args.save, exist_ok=True)
    out = os.path.join(args.save, f"{args.name}_inference")
    harness.infer_to_flo(ds, out)
    print(f"wrote {len(ds)} .flo files to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
