"""The model axis's halo exchanges: a frame's columns split over the ranks of
one group (the port's own module: the JAX package shards the width with
GSPMD, which inserts these exchanges itself and pads the uneven levels,
vid2vid_tpu/parallel/mesh.py).

Each rank of a width-sharded generator holds a contiguous range of the
columns of every pyramid and trunk level (`WidthShard`): level l, W_l =
W / 2**l columns wide, is split by its own rule, rank r of n holding
[r W_l // n, (r + 1) W_l // n). The finest width is a multiple of n (the
JAX package's own condition, `check_geometry`); a coarser level's ranges
may be unequal, and empty where the level has fewer columns than ranks.
Every rank derives every rank's ranges from (W, n, the level), so nothing
about them is sent. A layer finds its input's level by its height, which
no shard splits (`active`).

A layer that reads across columns takes the columns it reads first: each
rank's list of global columns (its `_need`, from its output columns),
read from whichever ranks own them, the reflection or the zeros of the
padding past the image's edges included. One all_gather moves them
(`_Fetch`): every rank sends the columns of its own that any other rank
reads, padded to the longest such list, and cuts what it reads from the
gathered lists by the ranges. It is differentiable: the backward sends
each read column's gradient back to its owner (one all_gather of every
rank's halo gradients), which adds up the gradients of its columns in
one order (the self reads first, then the ranks'). Its users:

  - the eval reflect-padded 7x7 and 3x3 convs (conv7, respair) run their
    kernels' column-halo mode: the input carries the columns of its
    inner sides (`exchange`, `attach`), and the kernel reflects only at
    the image's edges (`WidthShard.edges`, csrc/common.cuh::Cols), into
    the columns the input carries where the shard is narrower than the
    pad;
  - the reflection pads of the train-mode convs (`padded`), the
    zero-padded stride-2 down convs (`down_input`) and the transposed up
    convs (`up_input`), whose inputs and outputs lie on two levels split
    by their own rules, so that a rank may read columns it does not hold
    and hold columns it does not read;
  - in training, the zero-padded convs and pools of the discriminators
    and VGG (`window`), on tensors of any width (a 4x4 conv of padding 2
    gives W / 2 + 1 or W + 1 columns): each width is split by the same
    rule (`WidthShard.of_width`);
  - in training, FlowNet2 (models/flownet2): its zero-padded convs
    (`window`), its 4x4 stride-2 transposed convs (`transpose`), FlowNetC's
    correlation (`padded` with zeros: f2's 20 columns on each side, which
    span several ranks at a narrow shard) and its bilinear and nearest
    resizes between two widths (`resize`, ops/resize.py: the source
    columns a rank's output columns sample, clamped to the image's edge),
    each width split by the same rule. What every rank holds whole (the
    frames, their means) it cuts its windows from with no exchange
    (`fetch_plain`).

After each scale the generator gathers the whole frame (`gather_width`:
the unequal shards padded to the widest, then cut by the ranges) into its
previous frames, whose consumers differ by rank: the next frame's
previous-frame trunk reads this rank's columns of the ring (nn/
composite.py::local_columns), and its warp reads the whole previous frame
at this rank's column offset. The training losses take the frames at the
rank's columns (the discriminators, VGG and the losses run sharded; each
rank's loss is its share of the whole frame's, models/loss_engine.py);
what they read whole is gathered without a gradient (the previous frames
that the loss warps sample) or read whole on every rank (the face crop,
`gather`, whose loss each rank holds a 1 / n share of).

The gradient invariant: the gradient that reaches rank r's columns is the
replicated part counted once plus the per-rank parts summed over the
ranks. So `gather_width`'s backward keeps this rank's columns of the
whole tensor's gradient (the replicated part is the same on every rank,
and the trunk's part is this rank's own), while the warp's previous frame
passes through `shared` and the face crop through `gather`, whose
backwards sum the gradient over the ranks (each rank's part is its
share's). Each rank's gradients of its local activations are then the
whole model's, and a parameter's gradient on a rank is its share's: the
training step sums them over the model axis (train/steps.py::_apply).

Every rank makes every collective in the same order, forward and
backward, ranks with no columns at a level included (they send and read
nothing, padded lists of zeros): a collective one rank skipped would hang
the others. The layers' autograd graphs have the same structure on every
rank (a conv of a shard with no columns runs on zero columns and keeps
none, `valid_conv`), so the backward meets the collectives in
one order. An exchange that no rank needs (every list empty) is made by
none.

`fetch_plain` cuts what `_Fetch` gives a shard from the whole tensor on
one process, and `collectives.LocalGroup` runs N shards of one process on
N threads: with them the tests hold N shards against the whole tensor,
gradients included, without ranks. `columns` is the plain versions' view
of a column-halo input. The generator sets the shard of a frame
(`sharded`). With no shard set every layer computes what it computes
unsharded, by the same code.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import dataclasses
import functools

import numpy as np
import torch

from vid2vid_tpu_torch.parallel.collectives import all_gather, all_reduce

# the image-edge flags of csrc/common.cuh::Cols
LEFT_EDGE, RIGHT_EDGE = 1, 2
BOTH_EDGES = LEFT_EDGE | RIGHT_EDGE

# an attached halo input's left part and rows are padded to a multiple of
# this many columns (16 bytes in bf16): the kernels stage 16-byte aligned
# columns with tensor-map loads
ALIGN = 8

# the collectives of the model axis since the last reset, with the bytes
# each rank sent: halo exchanges (`exchange`, `padded`, `down_input`,
# `up_input`) and whole-width gathers (`gather_width`) in the forward; in
# the backward, the halo gradients' exchanges and the all-reduces of a
# shared tensor's gradient (`shared`; a gather's backward sends nothing)
COUNTS = {"exchanges": 0, "exchange_bytes": 0, "gathers": 0, "gather_bytes": 0,
          "exchanges_bwd": 0, "exchange_bytes_bwd": 0, "reduces_bwd": 0,
          "reduce_bytes_bwd": 0}


def reset_counts() -> None:
    """Zero COUNTS."""
    for k in COUNTS:
        COUNTS[k] = 0


def split(total: int, n: int, rank: int) -> tuple[int, int]:
    """Rank `rank`'s columns [x0, x1) of a level `total` wide on n ranks."""
    return rank * total // n, (rank + 1) * total // n


@dataclasses.dataclass(frozen=True)
class WidthShard:
    """Shard `index` of `n` on the model axis's `group`, at pyramid or
    trunk level `level` of frames width0 x height0 (level l: 2**l times
    narrower and lower): its columns [x0, x1) of the level's `total`
    (`split`)."""

    index: int
    n: int
    width0: int
    height0: int
    group: object = None
    level: int = 0

    @property
    def total(self) -> int:
        return self.width0 >> self.level

    def bounds(self, rank: int) -> tuple[int, int]:
        return split(self.total, self.n, rank)

    @property
    def x0(self) -> int:
        return self.bounds(self.index)[0]

    @property
    def x1(self) -> int:
        return self.bounds(self.index)[1]

    @property
    def width(self) -> int:
        return self.x1 - self.x0

    @property
    def left_edge(self) -> bool:
        return self.width > 0 and self.x0 == 0

    @property
    def right_edge(self) -> bool:
        return self.width > 0 and self.x1 == self.total

    @property
    def edges(self) -> int:
        """The sides that are the image's edges (LEFT_EDGE | RIGHT_EDGE)."""
        return (LEFT_EDGE if self.left_edge else 0) | (RIGHT_EDGE if self.right_edge else 0)

    def at(self, level: int) -> WidthShard:
        """This rank's shard of level `level` (0: the finest)."""
        f = 2**level
        if level < 0 or self.width0 % f or self.height0 % f:
            raise ValueError(f"frames {self.height0}x{self.width0} have no level {level}")
        return dataclasses.replace(self, level=level)

    def of_width(self, total: int) -> WidthShard:
        """This rank's shard, by the same rule, of a tensor `total` columns
        wide that is no pyramid level (a discriminator's or VGG's layer:
        `window`): its columns [r total // n, (r + 1) total // n)."""
        return dataclasses.replace(self, width0=total, height0=0, level=0)

    def level_of(self, x: torch.Tensor) -> WidthShard:
        """The shard of x's level, found by its height (which no shard
        splits)."""
        h = x.shape[-2]
        f = self.height0 // h if h else 0
        if f < 1 or self.height0 % h or f & (f - 1):
            raise ValueError(f"a height of {h} is no level of frames {self.height0} high")
        return self.at(f.bit_length() - 1)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's columns of a whole-width tensor (a view)."""
        if x.shape[-1] != self.total:
            raise ValueError(f"width {x.shape[-1]} is not the whole width {self.total}")
        return x[..., self.x0 : self.x1]


def local(x: torch.Tensor | None, shard: WidthShard | None) -> torch.Tensor | None:
    """This shard's columns of a whole-width tensor (a view); x itself
    without a shard."""
    return x if x is None or shard is None else shard.local(x)


def check_geometry(width: int, n: int, user: str = "a width-sharded engine") -> None:
    """Raise ValueError unless `width` columns split into n shards: the JAX
    package's condition, the width a multiple of n (its device_put of a
    width-sharded batch); the coarser levels split unevenly where they
    must. `user` names who asks (serving or training)."""
    if width < n or width % n:
        raise ValueError(f"{user}: width {width} on {n} ranks: the width must be a "
                         f"multiple of the ranks, {n}")


def make_shard(index: int, n: int, width: int, group=None, height: int = 1) -> WidthShard:
    """Shard `index` of `n` of frames `width` x `height` (the entry points
    hold the width to `check_geometry` first)."""
    return WidthShard(index, n, width, height, group)


# the shard of the frame being served (`sharded`), per thread
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("width_shard", default=None)


@contextlib.contextmanager
def sharded(shard: WidthShard | None):
    """Within the block, the layers of the model read `shard` (the finest
    level's of this frame) through `active`; None: unsharded."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active(x: torch.Tensor | None = None) -> WidthShard | None:
    """The shard set by `sharded` (None outside it, or for one shard); with
    x, the shard of x's level (`WidthShard.level_of`)."""
    shard = _ACTIVE.get()
    if shard is None or shard.n == 1:
        return None
    return shard if x is None else shard.level_of(x)


# ------------------------------------------------------------ what a rank reads


def _source(i: int, total: int, mode: str) -> int:
    """The column that global column i of the padded level reads: i inside
    the image; past its edges the reflection about the first or last
    column ("reflect"), that column itself ("edge") or -1, a zero
    ("zeros")."""
    if 0 <= i < total:
        return i
    if mode == "zeros":
        return -1
    if mode == "edge" and total:
        return 0 if i < 0 else total - 1
    j = -i if i < 0 else 2 * total - 2 - i
    if mode != "reflect" or not 0 <= j < total:
        raise ValueError(f"column {i} of a level {total} wide has no {mode!r} source")
    return j


def _halo_columns(x0: int, x1: int, left: int, right: int) -> tuple[range, range]:
    """The global columns of a halo of (left, right) around [x0, x1)."""
    return range(x0 - left, x0), range(x1, x1 + right)


def _need(spec: tuple, n: int, total: int, rank: int) -> list[int]:
    """The columns (`_source`s) of a level `total` wide that `rank` reads
    for the layer `spec`:

      - ("halo", left, right, mode): its columns with `left` and `right`
        more, padded past the image's edges by `mode` (`padded`);
      - ("strips", left, right): the left strip, then the right one, of a
        column-halo kernel's input, none on a side that is the image's
        edge (the kernel reflects there: `exchange`);
      - ("down",): the input columns 2a - 1 .. 2b - 1 of a 3x3 stride-2
        conv of zero padding 1 whose output columns, on the level half as
        wide, are [a, b) (`down_input`);
      - ("up",): the input columns a // 2 .. (b - 1) // 2 + 1 of a 3x3
        stride-2 transposed conv (padding 1, output padding 1) whose
        output columns, on the level twice as wide, are [a, b)
        (`up_input`);
      - ("window", k, stride, pad): the input columns stride a - pad ..
        stride (b - 1) - pad + k - 1 (zeros past the image's edges) of a
        k-wide window of `stride` and zero padding `pad` whose output
        columns, of the (total + 2 pad - k) // stride + 1 it has, are
        [a, b) (`window`): the discriminators' 4x4 convs (padding 2,
        stride 2 or 1), VGG's 3x3 convs (padding 1) and 2x2 max pools,
        the 3x3/s2 average pool between D copies (padding 1) and the 2x2
        average pool of the VGG loss; FlowNet2's convs (padding (k - 1) // 2);
      - ("transpose", k, stride, pad): the input columns ceil((a + pad - k
        + 1) / stride) .. (b - 1 + pad) // stride (zeros past the image's
        edges) of a k-wide transposed conv of `stride` and padding `pad`
        (no output padding) whose output columns, of the (total - 1)
        stride - 2 pad + k it has, are [a, b): every input column whose
        taps reach them (FlowNet's 4x4 stride-2 deconvs and upsamplings);
      - ("resize", out_total, mode): the source columns of a resize to
        out_total columns whose output columns are [a, b) (`resize_taps`):
        "linear", the first source column of each output column and the
        one after it, clamped to the image's edge past the last; "nearest",
        the one source column of each.

    A rank with no output columns reads none."""
    kind = spec[0]
    if kind == "halo":
        _, left, right, mode = spec
        x0, x1 = split(total, n, rank)
        if x0 == x1:
            return []
        return [_source(i, total, mode) for i in range(x0 - left, x1 + right)]
    if kind == "strips":
        _, left, right = spec
        x0, x1 = split(total, n, rank)
        if x0 == x1:
            return []
        lcols, rcols = _halo_columns(x0, x1, left, right)
        cols = ([] if x0 == 0 else list(lcols)) + ([] if x1 == total else list(rcols))
        return [_source(i, total, "reflect") for i in cols]
    if kind == "down":
        if total % 2:
            raise ValueError(f"a stride-2 conv of a level {total} wide")
        a, b = split(total // 2, n, rank)
        return [] if a == b else [_source(i, total, "zeros") for i in range(2 * a - 1, 2 * b)]
    if kind == "up":
        a, b = split(2 * total, n, rank)
        return ([] if a == b else
                [_source(i, total, "zeros") for i in range(a // 2, (b - 1) // 2 + 2)])
    if kind == "window":
        _, k, stride, pad = spec
        a, b = split(window_width(total, k, stride, pad), n, rank)
        return ([] if a == b else
                [_source(i, total, "zeros") for i in range(stride * a - pad,
                                                           stride * (b - 1) - pad + k)])
    if kind == "transpose":
        _, k, stride, pad = spec
        a, b = split(transpose_width(total, k, stride, pad), n, rank)
        return ([] if a == b else
                [_source(i, total, "zeros") for i in range(transpose_first(a, k, stride, pad),
                                                           (b - 1 + pad) // stride + 1)])
    if kind == "resize":
        _, out_total, mode = spec
        a, b = split(out_total, n, rank)
        if a == b:
            return []
        first, _ = resize_taps(total, out_total, a, b, mode)
        last = int(first[-1]) + (mode == "linear")
        return [_source(i, total, "edge") for i in range(int(first[0]), last + 1)]
    raise ValueError(f"unknown halo spec {spec!r}")


def window_width(total: int, k: int, stride: int, pad: int) -> int:
    """The output width of a k-wide window of `stride` and zero padding
    `pad` over `total` columns."""
    return (total + 2 * pad - k) // stride + 1


def transpose_width(total: int, k: int, stride: int, pad: int) -> int:
    """The output width of a k-wide transposed conv of `stride` and padding
    `pad` (no output padding) over `total` columns."""
    return (total - 1) * stride - 2 * pad + k


def transpose_first(a: int, k: int, stride: int, pad: int) -> int:
    """The first input column (maybe past the image's left edge) whose taps
    reach output column a of a k-wide transposed conv of `stride` and
    padding `pad`: output column o takes input column i at tap o + pad -
    stride i, in [0, k)."""
    return -((k - 1 - a - pad) // stride)


def resize_taps(in_total: int, out_total: int, a: int, b: int,
                mode: str) -> tuple[np.ndarray, np.ndarray]:
    """(first source column, weight of the column after it) of each output
    column in [a, b) of a resize from in_total to out_total columns (or
    rows), in PyTorch's float32 arithmetic (aten's upsample kernels), so
    that a shard samples where F.interpolate of the whole tensor samples:

      - "linear" (align_corners=False): the source coordinate (d + 0.5)
        in / out - 0.5, clamped at 0, the product and difference rounded
        once (the fused multiply-add that aten's kernels compile to, on
        the CPU and on the card; one rounding more moves the coordinate by
        an ulp of the width); its floor and fraction (the column after the
        floor, or the last column past it, takes the fraction);
      - "nearest": floor(d in / out) with in / out in float32, at most the
        last column; weight 0.
    """
    d = np.arange(a, b)
    scale = np.float32(in_total) / np.float32(out_total)
    if mode == "nearest":
        first = np.minimum(np.floor(d.astype(np.float32) * scale).astype(np.int64),
                           in_total - 1)
        return first, np.zeros(len(d), np.float32)
    if mode != "linear":
        raise ValueError(f"unknown resize mode {mode!r}")
    fused = np.float64(scale) * (d.astype(np.float32) + np.float32(0.5)) - 0.5
    src = np.maximum(fused.astype(np.float32), np.float32(0.0))
    first = src.astype(np.int64)
    return first, (src - first.astype(np.float32)).astype(np.float32)


class _Plan:
    """Who sends which columns of a level and who reads them, for one
    layer spec on n ranks (`_plan`). For each rank q:

      - send[q]: its local columns that other ranks read (sent padded
        with zeros to the longest such list, m);
      - fwd[q]: for each column it reads, its index into [own | zero |
        every rank's sent list], own = its columns `own[q]` (None: all);
      - bsend[q]: the positions of its read columns owned by other ranks
        (their halo gradients, sent back), padded to the longest (mb) with
        a zero position;
      - rounds[q]: the gradient of its columns as a sum of gathers from [its
        read columns' gradient | zero | every rank's bsend list]: round k
        takes each column's k-th reader (self reads first, then the ranks
        in order), or the zero.
    """

    def __init__(self, spec: tuple, n: int, total: int):
        ranges = [split(total, n, r) for r in range(n)]
        starts = [x0 for x0, _ in ranges]
        needs = [_need(spec, n, total, q) for q in range(n)]

        def owner(c: int) -> int:  # the last rank starting at or before c holds it
            return bisect.bisect_right(starts, c) - 1

        owners = [[-1 if c < 0 else owner(c) for c in need] for need in needs]
        widths = [x1 - x0 for x0, x1 in ranges]
        sent = [sorted({c for q in range(n) if q != r
                        for c, o in zip(needs[q], owners[q]) if o == r}) for r in range(n)]
        self.m = max(len(s) for s in sent)
        self.send = [[c - ranges[r][0] for c in s] for r, s in enumerate(sent)]
        slot = [{c: j for j, c in enumerate(s)} for s in sent]
        self.own, self.fwd = [], []
        for q in range(n):
            x0 = ranges[q][0]
            mine = sorted({c - x0 for c, o in zip(needs[q], owners[q]) if o == q})
            own = None if len(mine) == widths[q] else mine
            at = {c: c for c in range(widths[q])} if own is None else {c: j for j, c in
                                                                          enumerate(own)}
            zero = widths[q] if own is None else len(own)
            self.own.append(own)
            self.fwd.append([zero if o < 0 else at[c - x0] if o == q
                             else zero + 1 + o * self.m + slot[o][c]
                             for c, o in zip(needs[q], owners[q])])
        halos = [[p for p, o in enumerate(owners[q]) if o >= 0 and o != q] for q in range(n)]
        self.mb = max(len(h) for h in halos)
        self.bsend = [h + [len(needs[q])] * (self.mb - len(h)) for q, h in enumerate(halos)]
        readers = [[[] for _ in range(w)] for w in widths]
        for q in range(n):  # self reads first
            for p, (c, o) in enumerate(zip(needs[q], owners[q])):
                if o == q:
                    readers[q][c - ranges[q][0]].append(p)
        for q in range(n):
            for j, p in enumerate(halos[q]):
                o, c = owners[q][p], needs[q][p]
                readers[o][c - ranges[o][0]].append(len(needs[o]) + 1 + q * self.mb + j)
        self.rounds = []
        for r in range(n):
            depth = max((len(x) for x in readers[r]), default=0)
            self.rounds.append([[x[k] if k < len(x) else len(needs[r]) for x in readers[r]]
                                for k in range(depth)])
        self.halos = halos
        self._index: dict = {}

    def index(self, name: str, rank: int, device, k: int = 0) -> torch.Tensor:
        """One of the plan's index lists as a tensor on `device` (kept)."""
        key = (name, rank, k, str(device))
        if key not in self._index:
            lists = {"send": self.send, "fwd": self.fwd, "own": self.own, "bsend": self.bsend}
            idx = self.rounds[rank][k] if name == "round" else lists[name][rank]
            self._index[key] = torch.tensor(idx, dtype=torch.long, device=device)
        return self._index[key]


@functools.lru_cache(maxsize=512)
def _plan(spec: tuple, n: int, total: int) -> _Plan:
    return _Plan(spec, n, total)


def _zero_col(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1] + (1,))


class _Fetch(torch.autograd.Function):
    """The columns this rank reads for a layer spec (`_need`), gathered
    from their owners by one all_gather (`_Plan`); the backward returns
    each of x's columns' gradient: its own reads' plus what the other
    ranks send back for it (one all_gather of every rank's halo
    gradients)."""

    @staticmethod
    def forward(ctx, x, shard, spec):
        plan, q = _plan(spec, shard.n, shard.total), shard.index
        ctx.plan, ctx.q, ctx.group, ctx.w = plan, q, shard.group, x.shape[-1]
        parts = []
        if plan.m:
            send = x.index_select(-1, plan.index("send", q, x.device))
            if send.shape[-1] < plan.m:
                send = torch.cat([send, x.new_zeros(x.shape[:-1] + (plan.m - send.shape[-1],))],
                                 -1)
            parts = all_gather(send, shard.group)
            COUNTS["exchanges"] += 1
            COUNTS["exchange_bytes"] += send.numel() * send.element_size()
        own = x if plan.own[q] is None else x.index_select(-1, plan.index("own", q, x.device))
        return torch.cat([own, _zero_col(x), *parts], -1).index_select(
            -1, plan.index("fwd", q, x.device))

    @staticmethod
    def backward(ctx, g):
        plan, q = ctx.plan, ctx.q
        g = torch.cat([g, _zero_col(g)], -1)
        parts = []
        if plan.mb:
            send = g.index_select(-1, plan.index("bsend", q, g.device))
            parts = all_gather(send, ctx.group)
            COUNTS["exchanges_bwd"] += 1
            COUNTS["exchange_bytes_bwd"] += send.numel() * send.element_size()
        g = torch.cat([g, *parts], -1)
        gx = g.new_zeros(g.shape[:-1] + (ctx.w,))
        for k in range(len(plan.rounds[q])):
            gx = gx + g.index_select(-1, plan.index("round", q, g.device, k))
        return gx, None, None


def fetch(x: torch.Tensor, shard: WidthShard, spec: tuple, whole: bool = False) -> torch.Tensor:
    """The columns `_need(spec)` of this rank, x being its columns of
    shard's level: one all_gather over the shard's group, made by every
    rank (none where no rank reads another's columns). Differentiable.
    With `whole`, x is the whole tensor, which every rank holds: the
    columns are cut from it here (`fetch_plain`), with no exchange."""
    if whole:
        return fetch_plain(x, shard, spec)
    return _Fetch.apply(x, shard, spec)


def fetch_plain(whole: torch.Tensor, shard: WidthShard, spec: tuple) -> torch.Tensor:
    """`fetch` of shard's columns of the whole tensor, in one process: its
    columns cut from `whole` (differentiable with respect to it)."""
    need = _need(spec, shard.n, shard.total, shard.index)
    z = torch.cat([whole, _zero_col(whole)], -1)
    idx = torch.tensor([whole.shape[-1] if c < 0 else c for c in need], dtype=torch.long,
                       device=whole.device)
    return z.index_select(-1, idx)


def exchange(x: torch.Tensor, shard: WidthShard, left: int, right: int):
    """The columns that x's column-halo kernel reads beyond x: (the `left`
    columns before its first, the `right` after its last), reflected
    about the image's edges where they pass them, read from whichever
    ranks own them; None on a side that is the image's edge (the kernel
    reflects there) or takes no halo. Not differentiable (the eval
    kernels); `padded` is."""
    with torch.no_grad():
        cols = fetch(x, shard, ("strips", left, right))
    if not shard.width:
        return None, None
    nl = 0 if shard.left_edge or not left else left
    lstrip = cols[..., :nl] if nl else None
    rstrip = cols[..., nl:] if cols.shape[-1] > nl and right else None
    return lstrip, rstrip


def padded(x: torch.Tensor, shard: WidthShard, left: int, right: int,
           mode: str) -> torch.Tensor:
    """x with `left` and `right` halo columns, as a VALID layer of the
    whole tensor reads them: the columns of the ranks that own them, and
    past the image's edges `mode`'s padding ("reflect" or "zeros"). No
    columns on a shard with none. Differentiable."""
    return fetch(x, shard, ("halo", left, right, mode))


def padded_plain(whole: torch.Tensor, shard: WidthShard, left: int, right: int,
                 mode: str) -> torch.Tensor:
    """`padded` of shard's columns of the whole tensor, in one process."""
    return fetch_plain(whole, shard, ("halo", left, right, mode))


def down_input(x: torch.Tensor, shard: WidthShard) -> torch.Tensor:
    """The input columns 2a - 1 .. 2b - 1 (zeros past the image's edges)
    that a 3x3 stride-2 conv of padding 1 reads for this rank's columns
    [a, b) of the level below x's (half as wide): 2 (b - a) + 1 of them,
    none where it has no output column. Differentiable."""
    return fetch(x, shard, ("down",))


def up_input(x: torch.Tensor, shard: WidthShard) -> torch.Tensor:
    """The input columns a // 2 .. (b - 1) // 2 + 1 (zeros past the image's
    right edge) that a 3x3 stride-2 transposed conv (padding 1, output
    padding 1) reads for this rank's columns [a, b) of the level above
    x's (twice as wide), none where it has no output column.
    Differentiable."""
    return fetch(x, shard, ("up",))


def valid_conv(fn, x: torch.Tensor, k: int) -> torch.Tensor:
    """fn(x), a conv or pool that reads k input columns an output column
    (VALID along the width). On an input narrower than k (a shard with no
    columns) fn runs on k zero columns and its output keeps none: no
    columns, and the graph of every other rank, reaching x."""
    if x.shape[-1] >= k:
        return fn(x)
    return fn(torch.nn.functional.pad(x, (0, k - x.shape[-1])))[..., :0]


def window(x: torch.Tensor, shard: WidthShard, k: int, stride: int,
           pad: int, whole: bool = False) -> tuple[torch.Tensor, WidthShard]:
    """The input columns (zeros past the image's edges) that a k-wide
    window of `stride` and zero padding `pad` (a conv or a pool, VALID
    along the width on them) reads for this rank's output columns, x being
    its columns of a tensor `shard.total` wide (with `whole`, the whole
    tensor: `fetch`); and the output's shard (`WidthShard.of_width`).
    Differentiable."""
    out = shard.of_width(window_width(shard.total, k, stride, pad))
    return fetch(x, shard, ("window", k, stride, pad), whole), out


class _GatherWidth(torch.autograd.Function):
    """The whole width from every rank's columns; the backward keeps this
    rank's columns of the whole tensor's gradient (the gradient invariant:
    every consumer of the whole tensor is replicated or reads it through
    `shared`), summed over the ranks first with `summed` (a consumer whose
    loss each rank holds a share of)."""

    @staticmethod
    def forward(ctx, x, shard, summed):
        ctx.cols, ctx.group, ctx.summed = (shard.x0, shard.x1), shard.group, summed
        widths = [x1 - x0 for x0, x1 in map(shard.bounds, range(shard.n))]
        pad = max(widths) - x.shape[-1]
        send = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1) if pad else x.contiguous()
        parts = all_gather(send, shard.group)
        COUNTS["gathers"] += 1
        COUNTS["gather_bytes"] += send.numel() * send.element_size()
        return torch.cat([p[..., :w] for p, w in zip(parts, widths)], -1)

    @staticmethod
    def backward(ctx, g):
        x0, x1 = ctx.cols
        if ctx.summed:
            g = g.contiguous().clone()
            all_reduce(g, ctx.group)
            COUNTS["reduces_bwd"] += 1
            COUNTS["reduce_bytes_bwd"] += g.numel() * g.element_size()
        return g[..., x0:x1], None, None


def gather_width(x: torch.Tensor, shard: WidthShard) -> torch.Tensor:
    """The whole width of a tensor whose last dim is split over the ranks
    of shard's group (x this rank's columns of its level, found by its
    height), on every rank: one all_gather of the shards padded to the
    widest. Differentiable: the gradient keeps this rank's columns."""
    return _GatherWidth.apply(x, shard.level_of(x), False)


def gather(x: torch.Tensor, shard: WidthShard) -> torch.Tensor:
    """The whole of a tensor whose columns split as `shard` says (its own
    total, not a level of the frames: the face crop's rows), read whole by
    a loss that each rank holds a share of: the backward sums the gradient
    over the ranks (one all-reduce) and keeps this rank's columns."""
    return _GatherWidth.apply(x, shard, True)


class _Shared(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ctx.group)
        COUNTS["reduces_bwd"] += 1
        COUNTS["reduce_bytes_bwd"] += g.numel() * g.element_size()
        return g, None


def shared(x: torch.Tensor, shard: WidthShard) -> torch.Tensor:
    """A whole tensor that every rank of the shard's group reads at a
    place of its own (the warp's previous frame): x itself forward, its
    gradient summed over the ranks backward (one all-reduce, where x
    carries a gradient)."""
    if not x.requires_grad:
        return x
    return _Shared.apply(x, shard.group)


def attach(x: torch.Tensor, lstrip: torch.Tensor | None,
           rstrip: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """The column-halo input of a kernel, contiguous, and the column of x's
    first (xoff): [zeros | lstrip | x | rstrip | zeros], the left part
    ALIGN columns wide where there is a left strip (xoff = ALIGN: the
    kernels' tensor maps stage from 16-byte aligned columns, csrc/
    conv_wgmma.cuh::staging_bytes), the whole a multiple of ALIGN wide."""
    parts = [x] if rstrip is None else [x, rstrip]
    xoff = 0
    if lstrip is not None:
        if lstrip.shape[-1] > ALIGN:
            raise ValueError(f"a left halo of {lstrip.shape[-1]} columns is wider than {ALIGN}")
        xoff = ALIGN
        parts.insert(0, lstrip)
        if lstrip.shape[-1] < ALIGN:
            parts.insert(0, x.new_zeros(x.shape[:-1] + (ALIGN - lstrip.shape[-1],)))
    pad = -sum(p.shape[-1] for p in parts) % ALIGN
    if pad:
        parts.append(x.new_zeros(x.shape[:-1] + (pad,)))
    return torch.cat(parts, -1).contiguous(), xoff


def columns(x: torch.Tensor, xoff: int, width: int, lo: int, hi: int,
            edges: int) -> torch.Tensor:
    """Local columns lo .. hi - 1 of a column-halo input x, whose local
    column j (of `width`) is x's column j + xoff: reflected about column 0
    or width - 1 on the sides `edges` marks as the image's (i < 0 -> -i,
    i >= width -> 2 width - 2 - i, which may land in the halo of the other
    side on a shard narrower than the pad), read from x's halo elsewhere."""
    idx = torch.arange(lo, hi, device=x.device)
    if edges & LEFT_EDGE:
        idx = torch.where(idx < 0, -idx, idx)
    if edges & RIGHT_EDGE:
        idx = torch.where(idx >= width, 2 * width - 2 - idx, idx)
    idx = idx + xoff
    if int(idx.min()) < 0 or int(idx.max()) >= x.shape[-1]:
        raise ValueError(f"local columns {lo}:{hi} of {width} (edges {edges}) are not in "
                         f"an input of {x.shape[-1]} columns from column {xoff}")
    return x.index_select(-1, idx)
