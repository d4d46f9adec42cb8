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
