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
TPU kernel is; for anything else on a CUDA tensor the wrapper raises. The
gradient is `correlation_bwd`: on a CPU tensor the autograd of
`correlation_plain` (`correlation_backward_plain`), as the JAX package
differentiates `correlation_ref`; on a CUDA tensor the backward kernel of
csrc/correlation.cu (`v2v_correlation_bwd`, the same configuration and
dtype, or a raise).

The kernel's tile is mirrored here as plain constants (`TILE_ROWS`, ...;
the source note in csrc/correlation.cu explains them) with
`correlation_plan`, which sizes its grid and picks how many parts the
channel sum is split into; tests/test_torch_correlation_tiles.py walks that
map in numpy.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops.conv7 import plain_vjp, wants_grad

# the configuration the CUDA kernel is built for (FlowNetC's)
KERNEL_MAX_DISPLACEMENT = 20
KERNEL_STRIDE2 = 2

# csrc/correlation.cu's tile: a block owns TILE_ROWS output rows of one
# parity, TILE_DIAGS diagonals (one warp each; diagonal n holds the (row q,
# dy index j = n - q) pairs that read one f2 row) and TILE_X columns, and
# walks C in chunks of TILE_CHUNK channels. TILE_BLOCKS_PER_SM blocks fit an
# SM (registers: at most 255 a thread); the channel sum is split only where
# the grid would not fill the card once.
TILE_ROWS = 4
TILE_DIAGS = 4
TILE_X = 64
TILE_CHUNK = 16
TILE_STAGES = 2  # chunks in shared memory
TILE_BLOCKS_PER_SM = 2
KERNEL_RADIUS = KERNEL_MAX_DISPLACEMENT // KERNEL_STRIDE2  # 10
TILE_DIAGONALS = TILE_ROWS + 2 * KERNEL_RADIUS  # diagonals of a row group
TILE_DIAG_GROUPS = math.ceil(TILE_DIAGONALS / TILE_DIAGS)
TILE_WINDOW = TILE_X + 2 * KERNEL_MAX_DISPLACEMENT  # staged f2 columns a row
TILE_THREADS = 32 * TILE_DIAGS


def _odd_offset(half: int) -> int:
    """Where a staged row's odd columns start: the first offset >= the
    even half's length that is 16 (mod 32), so a warp's copy of 32
    consecutive columns writes disjoint banks (csrc/correlation.cu)."""
    return (half - 16 + 31) // 32 * 32 + 16


TILE_F2_ODD = _odd_offset(TILE_WINDOW // 2)  # 80
TILE_F2_ROW = TILE_F2_ODD + TILE_WINDOW // 2  # floats a staged f2 row: 132
TILE_F1_ODD = _odd_offset(TILE_X // 2)  # 48
TILE_F1_ROW = TILE_F1_ODD + TILE_X // 2  # 80
TILE_SMEM_BYTES = TILE_STAGES * 4 * TILE_CHUNK * (TILE_DIAGS * TILE_F2_ROW
                                                  + TILE_ROWS * TILE_F1_ROW)
H100_SMS = 132
# the backward kernel's block: BWD_TILE_X pixels of a row (one warp) x
# BWD_TILE_Y rows, BWD_CHUNK channels a thread (csrc/correlation.cu)
BWD_TILE_X, BWD_TILE_Y, BWD_CHUNK = 32, 8, 16


def correlation_bwd_grid(b: int, c: int, h: int, w: int) -> tuple[int, int, int]:
    """The backward kernel's grid at (B, C, H, W): (x tiles, row tiles,
    B * channel chunks); block z holds batch z // chunks, chunk z % chunks."""
    return (math.ceil(w / BWD_TILE_X), math.ceil(h / BWD_TILE_Y),
            b * math.ceil(c / BWD_CHUNK))


class CorrelationPlan(NamedTuple):
    grid: tuple[int, int, int]  # (x tiles, row groups * diagonal groups, B * 2 * split)
    split: int  # parts of the channel sum (1: no scratch, no second pass)
    chunks_per_part: int  # channel chunks a part sums


def correlation_plan(b: int, c: int, h: int, w: int, n_sm: int = H100_SMS) -> CorrelationPlan:
    """The kernel's launch at (B, C, H, W) on a card of `n_sm` SMs, as
    v2v_correlation takes it: split the channel sum into the fewest parts of
    equal chunk counts (the last may have fewer, never none) that fill
    TILE_BLOCKS_PER_SM blocks on every SM, or one chunk a part."""
    groups = math.ceil(math.ceil(h / 2) / TILE_ROWS)
    x_tiles = math.ceil(w / TILE_X)
    blocks = x_tiles * groups * TILE_DIAG_GROUPS * b * 2
    chunks = math.ceil(c / TILE_CHUNK)
    want = min(chunks, math.ceil(n_sm * TILE_BLOCKS_PER_SM / max(blocks, 1)))
    per_part = math.ceil(chunks / want)
    while per_part > 1 and math.ceil(chunks / per_part) < want:
        per_part -= 1
    split = math.ceil(chunks / per_part)
    return CorrelationPlan((x_tiles, groups * TILE_DIAG_GROUPS, b * 2 * split), split,
                           per_part)


def f2_stagings(h: int, w: int) -> float:
    """How many times the kernel copies each f2 value into shared memory,
    averaged over the image: the in-image taps of every block's staged
    window (out-of-image taps are zero-filled, not read), over H * W. The
    channel split does not change it (each part stages its own channels)."""
    staged = 0
    for par in range(2):
        hp = (h - par + 1) // 2
        for u0 in range(0, hp, TILE_ROWS):
            # the row group's diagonals n stage f2 row 2(u0 + n - R) + par
            rows = sum(0 <= 2 * (u0 + n - KERNEL_RADIUS) + par < h
                       for n in range(TILE_DIAG_GROUPS * TILE_DIAGS))
            for x0 in range(0, w, TILE_X):
                cols = min(w, x0 + TILE_X + KERNEL_MAX_DISPLACEMENT) - max(
                    0, x0 - KERNEL_MAX_DISPLACEMENT)
                staged += rows * cols
    return staged / (h * w)


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


def correlation_backward_plain(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor, max_displacement: int = 20,
    stride2: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2) for the cotangent g (B, D*D, H, W): the autograd of
    `correlation_plain`."""
    def plain(a, b):
        return correlation_plain(a, b, max_displacement, stride2)
    return plain_vjp(plain, (f1, f2), (True, True), g)


_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _kernel_operands(what, max_displacement, stride2, f1, **tensors) -> int:
    """Check a CUDA kernel call (FlowNetC's configuration, f32, contiguous,
    one CUDA device, C > 0); returns the dtype code."""
    if (max_displacement, stride2) != (KERNEL_MAX_DISPLACEMENT, KERNEL_STRIDE2):
        raise ValueError(
            f"{what}: the CUDA kernel takes max_displacement "
            f"{KERNEL_MAX_DISPLACEMENT}, stride2 {KERNEL_STRIDE2} (FlowNetC), "
            f"not {max_displacement}, {stride2}"
        )
    code = build.require_cuda_operands(what, f1.device, f1.dtype, f1=f1, **tensors)
    if f1.dtype != torch.float32:
        raise ValueError(f"{what}: dtype {f1.dtype} not supported (f32)")
    if f1.shape[1] == 0:
        raise ValueError(f"{what}: C must be positive")
    return code


def _correlation_forward(f1, f2, max_displacement, stride2) -> torch.Tensor:
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_displacement, stride2)
    code = _kernel_operands("correlation", max_displacement, stride2, f1, f2=f2)
    b, c, h, w = f1.shape
    d = 2 * (max_displacement // stride2) + 1
    fn = build.function("v2v_correlation", [_VOID] * 4 + [_INT] * 7 + [_VOID])
    out = torch.empty((b, d * d, h, w), dtype=torch.float32, device=f1.device)
    plan = correlation_plan(
        b, c, h, w, torch.cuda.get_device_properties(f1.device).multi_processor_count)
    scratch = None
    if plan.split > 1:  # the parts of the channel sum, added by a second pass
        scratch = torch.empty((plan.split, *out.shape), dtype=torch.float32,
                              device=f1.device)
    err = build.launch(fn, f1.device, f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(), b, c, h, w,
                       plan.split, plan.chunks_per_part, code)
    build.check(err, "correlation kernel launch")
    correlation.launches += 1
    correlation.second_kernels += plan.split > 1
    return out


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2):
        ctx.save_for_backward(f1, f2)
        ctx.config = (max_displacement, stride2)
        return _correlation_forward(f1, f2, max_displacement, stride2)

    @staticmethod
    def backward(ctx, g):
        df1, df2 = correlation_bwd(*ctx.saved_tensors, g.contiguous(), *ctx.config)
        n1, n2 = ctx.needs_input_grad[:2]
        return df1 if n1 else None, df2 if n2 else None, None, None


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2
) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, D*D, H, W) cost volume.

    A CPU tensor takes `correlation_plain`; a CUDA tensor launches the
    kernel (f32, contiguous, max_displacement 20, stride2 2) or raises. The
    gradient is `correlation_bwd`'s.
    """
    _check(f1, f2)
    if wants_grad(f1, f2):
        return _Correlation.apply(f1, f2, max_displacement, stride2)
    return _correlation_forward(f1, f2, max_displacement, stride2)


correlation.launches = 0
# the second passes that added a split channel sum's parts (a kernel each)
correlation.second_kernels = 0


def correlation_bwd(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor, max_displacement: int = 20,
    stride2: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(df1, df2), the gradients of `correlation(f1, f2)` for the cotangent
    g (B, D*D, H, W). A CPU tensor takes `correlation_backward_plain`; a CUDA
    tensor launches csrc/correlation.cu's backward kernel (f32, contiguous,
    max_displacement 20, stride2 2: one launch, the same bit for bit from
    run to run) or raises."""
    _check(f1, f2)
    d = 2 * (max_displacement // stride2) + 1
    b, c, h, w = f1.shape
    if tuple(g.shape) != (b, d * d, h, w):
        raise ValueError(f"correlation_bwd: g {tuple(g.shape)}, want {(b, d * d, h, w)}")
    if f1.device.type == "cpu":
        return correlation_backward_plain(f1, f2, g, max_displacement, stride2)
    code = _kernel_operands("correlation_bwd", max_displacement, stride2, f1, f2=f2, g=g)
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    fn = build.function("v2v_correlation_bwd", [_VOID] * 5 + [_INT] * 5 + [_VOID])
    err = build.launch(fn, f1.device, f1.data_ptr(), f2.data_ptr(), g.data_ptr(),
                       df1.data_ptr(), df2.data_ptr(), b, c, h, w, code)
    build.check(err, "correlation backward kernel launch")
    correlation_bwd.launches += 1
    return df1, df2


correlation_bwd.launches = 0
