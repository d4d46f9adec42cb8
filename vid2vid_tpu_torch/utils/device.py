"""The device an entry point runs on.

The port's entry points (InferenceEngine, FlowHarness, Trainer and the
CLIs) run on the first CUDA device unless the caller asks for the CPU.
Without a card they raise: they never fall back to the CPU.
"""

from __future__ import annotations

import torch


def require_device(device: torch.device | str = "cuda") -> torch.device:
    """`device` as a torch.device; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device (torch.cuda.is_available() is "
            "False); pass device='cpu' (the CLIs: --gpu_ids -1 or --device "
            "cpu) to run on the CPU"
        )
    return dev


def to_cpu(obj):
    """A copy of a nested dict / list / tuple of tensors with every tensor
    detached and on the CPU (what a checkpoint saves)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj
