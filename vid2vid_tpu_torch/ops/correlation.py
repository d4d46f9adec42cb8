"""The FlowNetC correlation cost volume (the port of ops/correlation.py and
ops/correlation_pallas.py), NCHW.

    out[b, (j+r)*D + (i+r), y, x] = mean_c f1[b, c, y, x] * f2[b, c, y + s*j, x + s*i]

for j, i in [-r, r], r = max_displacement // stride2, D = 2r + 1 (dy-major
channel index), with f2 zero outside the image (reference
correlation_cuda_kernel.cu:73-147). FlowNetC applies LeakyReLU(0.1) after
it; that stays in the network.

`correlation` runs `correlation_plain` on a CPU tensor and the hand-written
CUDA kernel csrc/correlation.cu on a CUDA tensor. The kernel is fixed to
FlowNetC's configuration (max displacement 20, stride2 2) and f32, as the
TPU kernel is; for anything else on a CUDA tensor the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build

# the configuration the CUDA kernel is built for (FlowNetC's)
KERNEL_MAX_DISPLACEMENT = 20
KERNEL_STRIDE2 = 2


def _check(f1: torch.Tensor, f2: torch.Tensor) -> None:
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"correlation: f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} must "
            "be equal (B, C, H, W)"
        )


def correlation_plain(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2
) -> torch.Tensor:
    """The cost volume as a displacement loop in plain PyTorch."""
    _check(f1, f2)
    _, c, h, w = f1.shape
    rad = max_displacement // stride2
    pad = max_displacement
    f2p = F.pad(f2, (pad, pad, pad, pad))
    planes = []
    for j in range(-rad, rad + 1):
        for i in range(-rad, rad + 1):
            y0, x0 = pad + j * stride2, pad + i * stride2
            shifted = f2p[:, :, y0 : y0 + h, x0 : x0 + w]
            planes.append((f1 * shifted).sum(1) / c)
    return torch.stack(planes, 1)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2
) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, D*D, H, W) cost volume.

    A CPU tensor takes `correlation_plain`; a CUDA tensor launches the
    kernel (f32, contiguous, max_displacement 20, stride2 2) or raises.
    """
    _check(f1, f2)
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_displacement, stride2)
    if (max_displacement, stride2) != (KERNEL_MAX_DISPLACEMENT, KERNEL_STRIDE2):
        raise ValueError(
            f"correlation: the CUDA kernel takes max_displacement "
            f"{KERNEL_MAX_DISPLACEMENT}, stride2 {KERNEL_STRIDE2} (FlowNetC), "
            f"not {max_displacement}, {stride2}"
        )
    code = build.require_cuda_operands(
        "correlation", f1.device, f1.dtype, f1=f1, f2=f2
    )
    if f1.dtype != torch.float32:
        raise ValueError(f"correlation: dtype {f1.dtype} not supported (f32)")
    b, c, h, w = f1.shape
    if c == 0:
        raise ValueError("correlation: C must be positive")
    d = 2 * (max_displacement // stride2) + 1
    fn = build.function("v2v_correlation", [_VOID] * 3 + [_INT] * 5 + [_VOID])
    out = torch.empty((b, d * d, h, w), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):  # launch on the operands' card
        err = fn(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, code,
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    build.check(err, "correlation kernel launch")
    correlation.launches += 1
    return out


correlation.launches = 0
