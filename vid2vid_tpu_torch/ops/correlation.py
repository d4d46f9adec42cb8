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

On training's model axis (parallel/halo.py) FlowNetC's correlation runs
on a width shard: `correlation(f1, f2, shard=shard)`, f1 and f2 this
rank's columns of the 1/8 level, fetches f2's 20 columns on each side
(`halo.padded`: the neighbours' columns, zeros past the image's edges) and
calls `correlation_halo`, the column-halo mode: csrc/correlation.cu's
`v2v_correlation_cols` on a CUDA tensor (the same kernel, f2's rows W + 40
long; forward only: FlowNet2 is frozen in training), `correlation_halo_plain`
on a CPU tensor. Its launches count on `correlation_halo`.

The kernel's tile is mirrored here as plain constants (`TILE_ROWS`, ...;
the source note in csrc/correlation.cu explains them) with
`correlation_plan`, which sizes its grid and picks how many parts the
channel sum is split into; tests/test_torch_correlation_tiles.py walks that
map in numpy. The backward's tile likewise (`BWD_*`,
`correlation_bwd_plan`, its one launch's grid), walked by
tests/test_torch_flow_train.py. `correlation_taps` counts the products
either direction needs (the taps inside the image), which is what its
bound counts. The column-halo mode's grid is the plan at the shard's
width, and its window's columns inside f2's padded row are staged
(`f2_stagings(..., halo=KERNEL_MAX_DISPLACEMENT)`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.kernels import build
from vid2vid_tpu_torch.ops.conv7 import plain_vjp, wants_grad
from vid2vid_tpu_torch.parallel import halo

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

# csrc/correlation.cu's backward tile: a block owns BWD_ROWS output rows of
# one parity, BWD_X columns and BWD_CHANNELS channels of one gradient, and
# walks the BWD_DIAGONALS f rows those rows meet (those inside the image),
# each staged once (the f row's window of BWD_WINDOW columns, split by
# parity into two arrays of BWD_F_ROW-float rows, the odd one at
# BWD_F_ODD; then the Q x 21 g rows it pairs with, BWD_G_ROW floats each,
# 4-pixel chunks of the two parities side by side). A thread owns 4
# same-parity pixels x BWD_THREAD_CHANNELS channels x the BWD_ROWS rows;
# BWD_BLOCKS_PER_SM blocks fit an SM.
BWD_ROWS = 4
BWD_X = 64
BWD_CHANNELS = 64
BWD_THREAD_CHANNELS = 8
BWD_THREADS = 128
BWD_STAGES = 2  # f rows in shared memory
BWD_BLOCKS_PER_SM = 2
BWD_DIAGONALS = BWD_ROWS + 2 * KERNEL_RADIUS  # 24
BWD_WINDOW = BWD_X + 2 * KERNEL_MAX_DISPLACEMENT  # 104
BWD_F_ROW = BWD_WINDOW // 2 + 1  # 53 (odd)
BWD_F_ODD = _odd_offset(BWD_CHANNELS * BWD_F_ROW)  # 3408
BWD_F_STAGE = BWD_F_ODD + BWD_CHANNELS * BWD_F_ROW  # 6800
BWD_G_ROW = BWD_X
BWD_G_STAGE = BWD_ROWS * (2 * KERNEL_RADIUS + 1) * BWD_G_ROW  # 5376
BWD_SMEM_BYTES = BWD_STAGES * 4 * (BWD_F_STAGE + BWD_G_STAGE)  # 97408


def correlation_taps(h: int, w: int, x0: int = 0, total: int | None = None) -> int:
    """The (y, x, j, i) with y and y + 2(j - R), x and x + 2(i - R) all
    inside an H x W image: the products one channel of one image needs,
    in the cost volume or in either gradient, with the zero taps outside
    the image left out. Rows and columns count apart: the rows' taps
    times the columns'. With x0 and total, the taps of a width shard's w
    columns from x0 of an image `total` wide: a tap that reads a
    neighbour's column is inside the image, only those past its edges are
    not."""
    def taps(n: int, p0: int, size: int) -> int:
        return sum(0 <= p + KERNEL_STRIDE2 * (j - KERNEL_RADIUS) < size
                   for p in range(p0, p0 + n) for j in range(2 * KERNEL_RADIUS + 1))
    return taps(h, 0, h) * taps(w, x0, w if total is None else total)


def correlation_bwd_rows(u0: int, hp: int) -> range:
    """The f rows (diagonals n) that a row group starting at u0 walks:
    those whose row 2(u0 + n - R) + parity lies in the image (hp rows of
    that parity)."""
    return range(max(0, KERNEL_RADIUS - u0), min(BWD_DIAGONALS, hp + KERNEL_RADIUS - u0))


def _bwd_row_groups(h: int) -> list[tuple[int, int]]:
    """(rows of the parity, first row u0) of every row group at height h."""
    return [((h - par + 1) // 2, u0) for par in range(2)
            for u0 in range(0, (h - par + 1) // 2, BWD_ROWS)]


def correlation_bwd_plan(b: int, c: int, h: int, w: int) -> tuple[int, int, int]:
    """The backward kernel's one launch at (B, C, H, W), as
    v2v_correlation_bwd makes it: the grid (channel blocks, row groups * x
    tiles, B * 2 gradients * 2 parities)."""
    groups = math.ceil(math.ceil(h / 2) / BWD_ROWS)
    return math.ceil(c / BWD_CHANNELS), groups * math.ceil(w / BWD_X), b * 4


def correlation_bwd_fmas(b: int, c: int, h: int, w: int) -> int:
    """The FMAs the backward kernel executes at (B, C, H, W), zero-filled
    pairs, channels and columns included: 21 steps of BWD_ROWS x BWD_X x
    BWD_CHANNELS a walked f row."""
    per_row = (2 * KERNEL_RADIUS + 1) * BWD_ROWS * BWD_X * BWD_CHANNELS
    rows = sum(len(correlation_bwd_rows(u0, hp)) for hp, u0 in _bwd_row_groups(h))
    return 2 * b * math.ceil(c / BWD_CHANNELS) * math.ceil(w / BWD_X) * rows * per_row


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


def f2_stagings(h: int, w: int, halo: int = 0) -> float:
    """How many times the kernel copies each f2 value into shared memory,
    averaged over the image: the in-image taps of every block's staged
    window (out-of-image taps are zero-filled, not read), over H * W. The
    channel split does not change it (each part stages its own channels).
    With `halo`, the column-halo mode's (f2 `halo` columns wider on each
    side, whose columns are all read: its neighbours' and the zeros past
    the image's edges), over H * w."""
    staged = 0
    for par in range(2):
        hp = (h - par + 1) // 2
        for u0 in range(0, hp, TILE_ROWS):
            # the row group's diagonals n stage f2 row 2(u0 + n - R) + par
            rows = sum(0 <= 2 * (u0 + n - KERNEL_RADIUS) + par < h
                       for n in range(TILE_DIAG_GROUPS * TILE_DIAGS))
            for x0 in range(0, w, TILE_X):
                cols = min(w + halo, x0 + TILE_X + KERNEL_MAX_DISPLACEMENT) - max(
                    -halo, x0 - KERNEL_MAX_DISPLACEMENT)
                staged += rows * cols
    return staged / (h * w)


def _check(f1: torch.Tensor, f2: torch.Tensor, halo_cols: int = 0) -> None:
    """f1 and f2 (B, C, H, W) alike, f2 `halo_cols` columns wider on each
    side in the column-halo mode."""
    want = tuple(f1.shape[:3]) + (f1.shape[3] + 2 * halo_cols,) if f1.dim() == 4 else None
    if f1.dim() != 4 or f2.dim() != 4 or tuple(f2.shape) != want:
        more = f", f2 {2 * halo_cols} columns wider" if halo_cols else ""
        raise ValueError(
            f"correlation: f1 {tuple(f1.shape)} and f2 {tuple(f2.shape)} must "
            f"be equal (B, C, H, W){more}"
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


def correlation_halo_plain(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2
) -> torch.Tensor:
    """The column-halo mode in plain PyTorch: f2 carries max_displacement
    more columns on each side (the neighbours' columns, zeros past the
    image's edges), its rows are padded with zeros here."""
    _check(f1, f2, max_displacement)
    _, c, h, w = f1.shape
    rad, pad = max_displacement // stride2, max_displacement
    f2p = F.pad(f2, (0, 0, pad, pad))
    planes = []
    for j in range(-rad, rad + 1):
        for i in range(-rad, rad + 1):
            y0, x0 = pad + j * stride2, pad + i * stride2
            planes.append((f1 * f2p[:, :, y0 : y0 + h, x0 : x0 + w]).sum(1) / c)
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
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2,
    shard: halo.WidthShard | None = None,
) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, D*D, H, W) cost volume.

    A CPU tensor takes `correlation_plain`; a CUDA tensor launches the
    kernel (f32, contiguous, max_displacement 20, stride2 2) or raises. The
    gradient is `correlation_bwd`'s. On a width shard (f1 and f2 this
    rank's columns of a level shard.total wide) it is this rank's columns
    of the whole cost volume: f2's halo fetched (`halo.padded`, zeros past
    the image's edges; one exchange, which every rank makes), then
    `correlation_halo`.
    """
    if shard is not None:
        _check(f1, f2)
        f2h = halo.padded(f2, shard, max_displacement, max_displacement, "zeros")
        if not shard.width:  # no columns here: no launch
            d = 2 * (max_displacement // stride2) + 1
            return f1.new_zeros((f1.shape[0], d * d, f1.shape[2], 0))
        return correlation_halo(f1.contiguous(), f2h.contiguous(), max_displacement, stride2)
    _check(f1, f2)
    if wants_grad(f1, f2):
        return _Correlation.apply(f1, f2, max_displacement, stride2)
    return _correlation_forward(f1, f2, max_displacement, stride2)


correlation.launches = 0
# the second passes that added a split channel sum's parts (a kernel each)
correlation.second_kernels = 0


def correlation_halo(
    f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 20, stride2: int = 2
) -> torch.Tensor:
    """The column-halo mode: f1 a width shard's (B, C, H, W) columns, f2
    (B, C, H, W + 2 max_displacement) the same columns with max_displacement
    more on each side (the neighbours', zeros past the image's edges) ->
    the shard's (B, D*D, H, W) columns of the whole cost volume, forward
    only. A CPU tensor takes `correlation_halo_plain`; a CUDA tensor
    launches csrc/correlation.cu's `v2v_correlation_cols` (f32, contiguous,
    max_displacement 20, stride2 2, no gradient wanted) or raises."""
    _check(f1, f2, max_displacement)
    if f1.device.type == "cpu":
        return correlation_halo_plain(f1, f2, max_displacement, stride2)
    if wants_grad(f1, f2):
        raise ValueError("correlation_halo: the column-halo kernel has no backward "
                         "(FlowNet2 runs frozen, under no_grad)")
    code = _kernel_operands("correlation_halo", max_displacement, stride2, f1, f2=f2)
    b, c, h, w = f1.shape
    d = 2 * (max_displacement // stride2) + 1
    out = torch.empty((b, d * d, h, w), dtype=torch.float32, device=f1.device)
    if out.numel() == 0:
        return out
    fn = build.function("v2v_correlation_cols", [_VOID] * 4 + [_INT] * 7 + [_VOID])
    plan = correlation_plan(
        b, c, h, w, torch.cuda.get_device_properties(f1.device).multi_processor_count)
    scratch = None
    if plan.split > 1:
        scratch = torch.empty((plan.split, *out.shape), dtype=torch.float32,
                              device=f1.device)
    err = build.launch(fn, f1.device, f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(), b, c, h, w,
                       plan.split, plan.chunks_per_part, code)
    build.check(err, "correlation column-halo kernel launch")
    correlation_halo.launches += 1
    correlation_halo.second_kernels += plan.split > 1
    return out


correlation_halo.launches = 0
correlation_halo.second_kernels = 0


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
