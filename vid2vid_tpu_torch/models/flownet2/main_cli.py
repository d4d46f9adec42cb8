"""Standalone flow-net CLI (the port of vid2vid_tpu/models/flownet2/main_cli.py;
the reference's flownet2_pytorch/main.py): train a flow net, or write its
flows.

Reflection-driven flags like the reference's `tools.add_arguments_for_module`
(flownet2_pytorch/utils/tools.py:55-86): every keyword argument of the
chosen model / training / validation / inference dataset class is exposed
as `--model_<kwarg>` / `--training_dataset_<kwarg>` /
`--validation_dataset_<kwarg>` / `--inference_dataset_<kwarg>`.

    python -m vid2vid_tpu_torch.models.flownet2.main_cli --model FlowNetC \\
        --training_dataset FlyingChairs --training_dataset_root chairs/ \\
        --validation_dataset FlyingChairs --validation_dataset_root chairs_val/ \\
        --total_epochs 10 --save ./work --name run

trains from the network's seeded initialisation (--seed) with Adam (--lr,
--fp16: bf16 compute on f32 master weights), validates each epoch and
writes <save>/<name>_checkpoint.pth.tar, and <name>_model_best.pth.tar on
a new best validation EPE. `--resume latest|best` restores one of them
(weights and Adam state) first. With `--inference` it writes
<save>/<name>_inference/NNNNNN.flo, one per consecutive frame pair of the
inference dataset, instead of training. It runs on the first CUDA device
(`--device cuda`, the default; it raises without one) or, with `--device
cpu`, on the CPU; the datasets read images with PIL.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys

import torch

from vid2vid_tpu_torch.models.flownet2 import datasets as flow_datasets
from vid2vid_tpu_torch.models.flownet2 import nets as flow_nets
from vid2vid_tpu_torch.models.flownet2.harness import FlowHarness


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
    pre.add_argument("--training_dataset", default="FlyingChairs", choices=sorted(DATASETS))
    pre.add_argument("--validation_dataset", default="MpiSintelClean",
                     choices=sorted(DATASETS))
    pre.add_argument("--inference_dataset", default="ImagesFromFolder",
                     choices=sorted(DATASETS))
    known, _ = pre.parse_known_args(argv)

    parser = argparse.ArgumentParser(parents=[pre], allow_abbrev=False)
    parser.add_argument("--total_epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--div_flow", type=float, default=0.05)
    parser.add_argument("--fp16", action="store_true",
                        help="bf16 compute, f32 master params")
    parser.add_argument("--save", default="./work")
    parser.add_argument("--name", default="run")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--inference", action="store_true")
    parser.add_argument("--resume", default="", choices=("", "latest", "best"))
    parser.add_argument("--log_frequency", type=int, default=50)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    add_arguments_for_module(parser, "model", MODELS[known.model])
    if "input_channels" in inspect.signature(MODELS[known.model].__init__).parameters:
        parser.set_defaults(model_input_channels=6)  # the stacked frame pair
    for role in ("training_dataset", "validation_dataset", "inference_dataset"):
        add_arguments_for_module(parser, role, DATASETS[getattr(known, role)])
    args = parser.parse_args(argv)

    model_cls = MODELS[args.model]
    mkw = _kwargs_for(args, "model", model_cls)
    if "train_outputs" in inspect.signature(model_cls.__init__).parameters:
        mkw.setdefault("train_outputs", True)
    net = model_cls(**mkw)
    flow_nets.init_flownet_weights(net, torch.Generator().manual_seed(args.seed))
    harness = FlowHarness(net, lr=args.lr, div_flow=args.div_flow,
                          mixed_precision=args.fp16, device=args.device)

    os.makedirs(args.save, exist_ok=True)
    if args.resume:
        epoch, best = harness.restore_checkpoint(args.save, prefix=args.name,
                                                 best=args.resume == "best")
        print(f"resumed {args.resume} (epoch {epoch}, best EPE {best:.3f})")

    def dataset(role: str):
        cls = DATASETS[getattr(args, role)]
        return cls(**_kwargs_for(args, role, cls))

    if args.inference:
        ds = dataset("inference_dataset")
        out = os.path.join(args.save, f"{args.name}_inference")
        harness.infer_to_flo(ds, out)
        print(f"wrote {len(ds)} .flo files to {out}")
        return 0

    train_ds, val_ds = dataset("training_dataset"), dataset("validation_dataset")
    print(f"train: {len(train_ds)} pairs, val: {len(val_ds)} pairs")
    best = harness.fit(train_ds, val_ds, args.total_epochs, save_dir=args.save,
                       prefix=args.name, log_every=args.log_frequency)
    print(f"best val EPE: {best:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
