"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes, rooflines, and a step's operations counted from the plain
reference.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 and fp16 on the tensor cores; f32 work runs
against 165 TFLOP/s, TF32's 495 split three ways (3xTF32, the fastest
route on the card that keeps f32's accuracy), so that no f32 kernel can
read above 100%; 3.35 TB/s of HBM.

Operations are counted from the configuration's plain reference
(reference/<family>.py), run on the `meta` device under FlopCounterMode at
the cell's shapes: the same count whatever implements the work, a
convolution counted 2 operations a multiply-add. A kernel family's work
is the sum, over the reference's modules that the family implements, of
each call's larger bound: operations over the peak, or each input, output
and weight byte read or written once over HBM's bandwidth.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 165e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float, dtype: torch.dtype) -> float:
    """The least time the card could take: operations over the dtype's
    peak or bytes over HBM's bandwidth, the larger."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S)


def conv_flops(b: int, ci: int, co: int, h: int, w: int, k: int) -> float:
    """A stride-1 k x k convolution with an output of (b, co, h, w)."""
    return 2.0 * b * h * w * ci * co * k * k


def respair_work(b: int, c: int, h: int, w: int, elem: int) -> tuple[float, float]:
    """(operations, bytes) of one ResnetBlock on (b, c, h, w): two 3x3
    convs; x read and the output written once in the compute dtype (`elem`
    bytes), both weights once, and each conv's folded f32 scale and shift."""
    flops = 2 * conv_flops(b, c, c, h, w, 3)
    n_bytes = 2 * b * c * h * w * elem + 2 * 9 * c * c * elem + 2 * 2 * c * 4
    return flops, n_bytes


def conv7_work(b: int, ci: int, co: int, h: int, w: int, elem: int) -> tuple[float, float]:
    """(operations, bytes) of one reflect-padded 7x7 conv (b, ci, h, w) ->
    (b, co, h, w): input and output once in the compute dtype, the weight
    once, the f32 bias."""
    flops = conv_flops(b, ci, co, h, w, 7)
    n_bytes = b * (ci + co) * h * w * elem + 49 * ci * co * elem + co * 4
    return flops, n_bytes


def _is_conv7(m: nn.Module) -> bool:
    return isinstance(m, nn.Conv2d) and m.kernel_size == (7, 7) and m.stride == (1, 1)


def _is_resblock(m: nn.Module) -> bool:
    return type(m).__name__ == "ResnetBlock"


def count_step(ref: nn.Module, step, dtype: torch.dtype) -> dict:
    """Run `step()` (the reference's step at the cell's shapes, on `meta`)
    under FlopCounterMode, with the reference `ref`'s ResnetBlocks and 7x7
    convs recorded: {"flops": the step's operations, "respair" / "conv7":
    the family's bound in seconds for the step}."""
    elem = torch.tensor([], dtype=dtype).element_size()
    bounds = {"respair": 0.0, "conv7": 0.0}

    def hook(m, args, out):  # the output's shape: a 7x7 conv's input is padded
        b, co, h, w = out.shape
        if _is_resblock(m):
            bounds["respair"] += bound_s(*respair_work(b, co, h, w, elem), dtype)
        else:
            bounds["conv7"] += bound_s(*conv7_work(b, args[0].shape[1], co, h, w, elem), dtype)

    handles = [m.register_forward_hook(hook) for m in ref.modules()
               if _is_resblock(m) or _is_conv7(m)]
    try:
        with FlopCounterMode(display=False) as counter:
            step()
    finally:
        for h in handles:
            h.remove()
    return {"flops": float(counter.get_total_flops()), **bounds}
