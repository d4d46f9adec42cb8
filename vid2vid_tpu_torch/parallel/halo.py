"""The model axis's halo exchanges: a frame's columns split over the ranks of
one group (the port's own module: the JAX package shards the width with
GSPMD, which inserts these exchanges itself, vid2vid_tpu/parallel/mesh.py).

Each rank of a width-sharded generator holds a contiguous range of the
frame's columns at every pyramid and trunk level (`WidthShard`). A layer
that reads across columns takes its neighbours' edge columns first (one
all_gather of every rank's packed edge strips), then computes its local
columns alone:

  - the eval reflect-padded 7x7 and 3x3 convs (conv7, respair) run their
    kernels' column-halo mode: the input carries the neighbours' columns
    on its inner sides (`exchange`, `attach`), and reflects only at the
    image's edges (`WidthShard.edges`, csrc/common.cuh::Cols);
  - the reflection pads of the train-mode convs and the zero-padded
    stride-2 down convs and transposed up convs take `padded`: the input
    with its halo columns attached, reflected or zero only at the image's
    edges. It is differentiable: its backward sends each halo column's
    gradient back to the rank that owns the column, which adds it to its
    edge columns (one all_gather of packed strips, as the forward's).

After each scale the generator gathers the whole frame (`gather_width`).
Every rank then holds the whole frames, which feed two kinds of consumer:

  - replicated consumers compute the same thing on every rank: the
    losses, the discriminators, VGG;
  - per-rank consumers differ by rank: the next frame's previous-frame
    trunk reads this rank's columns of the ring (nn/composite.py::
    local_columns), and its warp reads the whole previous frame at this
    rank's column offset.

The gradient invariant: the gradient that reaches rank r's columns is the
replicated part counted once plus the per-rank parts summed over the
ranks. So `gather_width`'s backward keeps this rank's columns of the
whole frame's gradient (the replicated part is the same on every rank,
and the trunk's part is this rank's own), and the warp's previous frame
passes through `shared`, the identity whose backward sums the gradient
over the ranks. Each rank's gradients of its local activations are then
the whole model's, and a parameter's gradient on a rank is its columns'
share: the training step sums them over the model axis
(train/steps.py::_apply).

Every rank makes every collective in the same order, forward and
backward, the ranks at the image's edges included (they send strips that
no neighbour reads): a collective one rank skipped would hang the others.
The layers' autograd graphs have the same structure on every rank, so the
backward meets the collectives in one order.

`with_halo_plain` and `padded_plain` assemble a padded tensor on one
process from the strips of the whole tensor, and `collectives.LocalGroup`
runs N shards of one process on N threads: with them the tests hold N
shards against the whole tensor, gradients included, without ranks.
`columns` is the plain versions' view of a column-halo input. The
generator sets the shard of a frame (`sharded`); a layer finds its
level's shard by its input's width (`active`). With no shard set every
layer computes what it computes unsharded, by the same code.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from vid2vid_tpu_torch.parallel.collectives import all_gather, all_reduce, group_rank

# the image-edge flags of csrc/common.cuh::Cols
LEFT_EDGE, RIGHT_EDGE = 1, 2
BOTH_EDGES = LEFT_EDGE | RIGHT_EDGE

# an attached halo input's left part and rows are padded to a multiple of
# this many columns (16 bytes in bf16): the kernels stage 16-byte aligned
# columns with tensor-map loads
ALIGN = 8

# the collectives of the model axis since the last reset, with the bytes
# each rank sent: halo exchanges (`exchange`, `padded`) and whole-width
# gathers (`gather_width`) in the forward; in the backward, the halo
# gradients' exchanges (`padded`) and the all-reduces of a shared tensor's
# gradient (`shared`; a gather's backward sends nothing)
COUNTS = {"exchanges": 0, "exchange_bytes": 0, "gathers": 0, "gather_bytes": 0,
          "exchanges_bwd": 0, "exchange_bytes_bwd": 0, "reduces_bwd": 0,
          "reduce_bytes_bwd": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class WidthShard:
    """This rank's columns of a level: [x0, x0 + width) of `total`, shard
    `index` of `n` on the model axis's `group`."""

    index: int
    n: int
    x0: int
    width: int
    total: int
    group: object = None

    @property
    def left_edge(self) -> bool:
        return self.x0 == 0

    @property
    def right_edge(self) -> bool:
        return self.x0 + self.width == self.total

    @property
    def edges(self) -> int:
        """The sides that are the image's edges (LEFT_EDGE | RIGHT_EDGE)."""
        return (LEFT_EDGE if self.left_edge else 0) | (RIGHT_EDGE if self.right_edge else 0)

    def at(self, level: int, factor: int = 2) -> WidthShard:
        """The shard `level` levels coarser, each `factor` times narrower."""
        f = factor**level
        if self.x0 % f or self.width % f or self.total % f:
            raise ValueError(f"shard {self.x0}:{self.x0 + self.width} of {self.total} does "
                             f"not divide into a level {f}x coarser")
        return dataclasses.replace(self, x0=self.x0 // f, width=self.width // f,
                                   total=self.total // f)

    def for_width(self, width: int) -> WidthShard:
        """The shard of the level whose local width is `width` (this shard's
        level or a coarser one)."""
        if width == self.width:
            return self
        if width <= 0 or self.width % width or (self.width // width) & (self.width // width - 1):
            raise ValueError(f"a local width of {width} is no level of shard width {self.width}")
        return self.at(1, self.width // width)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's columns of a whole-width tensor (a view)."""
        if x.shape[-1] != self.total:
            raise ValueError(f"width {x.shape[-1]} is not the whole width {self.total}")
        return x[..., self.x0 : self.x0 + self.width]


def make_shard(index: int, n: int, total: int, group=None) -> WidthShard:
    """Shard `index` of `n` equal ones of `total` columns."""
    if total % n:
        raise ValueError(f"width {total} does not divide into {n} shards")
    w = total // n
    return WidthShard(index, n, index * w, w, total, group)


def check_geometry(width: int, n: int, pyramid: int, trunk: int,
                   user: str = "a width-sharded engine") -> None:
    """Raise ValueError unless `width` columns split into n shards that hold
    whole, even-aligned columns at every level: the width divisible by n x
    the pyramid factor x the trunk factor, and each shard at least as wide
    as the widest halo of every level, 3 at the coarsest pyramid level (the
    7x7 convs) and 2 at the coarsest trunk level (the residual blocks).
    JAX pads uneven shards; the port refuses them. `user` names who asks
    (serving or training)."""
    unit = n * pyramid * trunk
    least = max(2 * unit, 3 * n * pyramid)
    if width % unit or width < least:
        raise ValueError(
            f"{user}: width {width} on {n} ranks: the width must be a multiple of ranks x "
            f"pyramid x trunk factors = {n} x {pyramid} x {trunk} = {unit}, and at "
            f"least {least}: each shard holds 3 columns at the coarsest pyramid level "
            f"(the 7x7 convs' halo) and 2 at the coarsest trunk level (the residual "
            f"blocks')")


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
    x, the shard of x's level, found by its width."""
    shard = _ACTIVE.get()
    if shard is None or shard.n == 1:
        return None
    return shard if x is None else shard.for_width(x.shape[-1])


def edge_strips(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """What a rank sends: its first `right` columns (its left neighbour's
    right halo), then its last `left` columns (its right neighbour's left
    halo)."""
    w = x.shape[-1]
    return torch.cat([x[..., :right], x[..., w - left:]], -1).contiguous()


def exchange(x: torch.Tensor, shard: WidthShard, left: int, right: int):
    """The neighbours' columns that x's layer reads: (its left neighbour's
    last `left` columns, its right neighbour's first `right` columns), None
    on a side that is the image's edge or takes no halo. One all_gather
    over the shard's group of every rank's packed strips (B, C, H, left +
    right): for two ranks what a pairwise exchange sends. Not
    differentiable (the eval kernels' column-halo modes); `padded` is."""
    w = x.shape[-1]
    if max(left, right) > w:
        raise ValueError(f"a halo of {max(left, right)} columns is wider than the shard's {w}")
    send = edge_strips(x, left, right)
    parts = all_gather(send, shard.group)
    COUNTS["exchanges"] += 1
    COUNTS["exchange_bytes"] += send.numel() * send.element_size()
    lstrip = (None if shard.left_edge or left == 0
              else parts[shard.index - 1][..., right:])
    rstrip = (None if shard.right_edge or right == 0
              else parts[shard.index + 1][..., :right])
    return lstrip, rstrip


class _Exchange(torch.autograd.Function):
    """[left halo | x | right halo]: the neighbours' columns (`exchange`),
    zeros on a side that is the image's edge. The backward returns x's
    part of the gradient plus the halo gradients the neighbours send back
    for x's edge columns: one all_gather of every rank's packed halo
    gradients, made by every rank."""

    @staticmethod
    def forward(ctx, x, shard, left, right):
        ctx.shard, ctx.left, ctx.right = shard, left, right
        lstrip, rstrip = exchange(x, shard, left, right)
        lpad = x.new_zeros(x.shape[:-1] + (left,)) if lstrip is None else lstrip
        rpad = x.new_zeros(x.shape[:-1] + (right,)) if rstrip is None else rstrip
        return torch.cat([lpad, x, rpad], -1)

    @staticmethod
    def backward(ctx, g):
        shard, left, right = ctx.shard, ctx.left, ctx.right
        w = g.shape[-1] - left - right
        # what this rank's halos read: its left neighbour's last `left`
        # columns, its right neighbour's first `right`
        send = torch.cat([g[..., :left], g[..., left + w:]], -1).contiguous()
        parts = all_gather(send, shard.group)
        COUNTS["exchanges_bwd"] += 1
        COUNTS["exchange_bytes_bwd"] += send.numel() * send.element_size()
        gx = g[..., left : left + w].clone()
        if left and not shard.right_edge:  # my right neighbour's left halo: my last columns
            gx[..., w - left:] += parts[shard.index + 1][..., :left]
        if right and not shard.left_edge:  # my left neighbour's right halo: my first columns
            gx[..., :right] += parts[shard.index - 1][..., left:]
        return gx, None, None, None


def _pad_edges(y: torch.Tensor, shard: WidthShard, left: int, right: int,
               mode: str) -> torch.Tensor:
    """y = [left halo | x | right halo] with the sides that are the image's
    edges padded by `mode`: reflected about x's first / last column
    ("reflect"), or left as they are (zeros)."""
    if mode == "zeros":
        return y
    if mode != "reflect":
        raise ValueError(f"unknown halo mode {mode!r}")
    w = y.shape[-1] - left - right
    if (left and shard.left_edge and left >= w) or (right and shard.right_edge and right >= w):
        raise ValueError(f"a reflected halo of {max(left, right)} columns needs a shard wider "
                         f"than {w}")
    x = y[..., left : left + w]
    lpad = x[..., 1 : left + 1].flip(-1) if shard.left_edge else y[..., :left]
    rpad = x[..., w - 1 - right : w - 1].flip(-1) if shard.right_edge else y[..., left + w:]
    return torch.cat([lpad, x, rpad], -1)


def padded(x: torch.Tensor, shard: WidthShard, left: int, right: int,
           mode: str) -> torch.Tensor:
    """x with `left` and `right` halo columns, as a VALID layer of the
    whole tensor reads them: the neighbours' columns on inner sides and,
    on a side that is the image's edge, `mode`'s padding ("reflect" or
    "zeros"). Differentiable: the halos' gradient goes back to the ranks
    that own their columns (`_Exchange`)."""
    return _pad_edges(_Exchange.apply(x, shard, left, right), shard, left, right, mode)


def padded_plain(whole: torch.Tensor, shard: WidthShard, left: int, right: int,
                 mode: str) -> torch.Tensor:
    """`padded` of shard's columns of the whole tensor, in one process: the
    halos cut from `whole` (differentiable with respect to it)."""
    x0, w = shard.x0, shard.width
    lstrip = None if shard.left_edge or not left else whole[..., x0 - left : x0]
    rstrip = None if shard.right_edge or not right else whole[..., x0 + w : x0 + w + right]
    return with_halo_plain(shard.local(whole), lstrip, rstrip, shard, mode, (left, right))


class _GatherWidth(torch.autograd.Function):
    """The whole width from every rank's columns; the backward keeps this
    rank's columns of the whole tensor's gradient (the gradient
    invariant: every consumer of the whole tensor is replicated or reads
    it through `shared`)."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.index, ctx.width = group_rank(group), x.shape[-1]
        x = x.contiguous()
        parts = all_gather(x, group)
        COUNTS["gathers"] += 1
        COUNTS["gather_bytes"] += x.numel() * x.element_size()
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        x0 = ctx.index * ctx.width
        return g[..., x0 : x0 + ctx.width], None, None


def gather_width(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The whole width of a tensor whose last dim is split in rank order
    over the n ranks of `group`, on every rank: one all_gather.
    Differentiable: the gradient keeps this rank's columns."""
    return _GatherWidth.apply(x, n, group)


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
    i >= width -> 2 width - 2 - i), read from x's halo elsewhere."""
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


def with_halo_plain(x: torch.Tensor, lstrip: torch.Tensor | None,
                    rstrip: torch.Tensor | None, shard: WidthShard, mode: str,
                    halo: tuple[int, int]) -> torch.Tensor:
    """x with halo = (left, right) columns on its sides, as a VALID layer of
    the whole tensor reads them: the strips on inner sides, and on a side
    that is the image's edge `mode`'s padding ("reflect" or "zeros")."""
    left, right = halo
    if mode == "reflect":
        edges = shard.edges
        xin, xoff = attach(x, None if shard.left_edge else lstrip,
                           None if shard.right_edge else rstrip)
        return columns(xin, xoff, x.shape[-1], -left, x.shape[-1] + right, edges)
    if mode != "zeros":
        raise ValueError(f"unknown halo mode {mode!r}")
    lpad = x.new_zeros(x.shape[:-1] + (left,)) if shard.left_edge else lstrip
    rpad = x.new_zeros(x.shape[:-1] + (right,)) if shard.right_edge else rstrip
    return torch.cat([p for p in (lpad, x, rpad) if p is not None], -1)
