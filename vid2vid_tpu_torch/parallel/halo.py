"""The model axis's halo exchanges: a frame's columns split over the ranks of
one group (the port's own module: the JAX package shards the width with
GSPMD, which inserts these exchanges itself, vid2vid_tpu/parallel/mesh.py).

Each rank of a width-sharded engine holds a contiguous range of the
frame's columns at every pyramid and trunk level (`WidthShard`). A layer
that reads across columns takes its neighbours' edge columns first
(`exchange`: one all_gather of every rank's packed edge strips), then
computes its local columns alone:

  - the reflect-padded 7x7 and 3x3 convs (conv7, respair) run their
    kernels' column-halo mode: the input carries the neighbours' columns
    on its inner sides (`attach`), and reflects only at the image's edges
    (`WidthShard.edges`, csrc/common.cuh::Cols);
  - the zero-padded stride-2 down convs and the transposed up convs take
    their halos as columns and zero padding only at the image's edges
    (`with_halo_plain(..., "zeros")`).

`with_halo_plain` assembles a padded tensor on one process from the strips
(the tests hold N shards against the whole tensor with it, without ranks);
`columns` is the plain versions' view of a column-halo input. The engine
sets the shard of a frame (`sharded`); a layer finds its level's shard by
its input's width (`active`). With no shard set every layer computes what
it computes unsharded, by the same code.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

# the image-edge flags of csrc/common.cuh::Cols
LEFT_EDGE, RIGHT_EDGE = 1, 2
BOTH_EDGES = LEFT_EDGE | RIGHT_EDGE

# an attached halo input's left part and rows are padded to a multiple of
# this many columns (16 bytes in bf16): the kernels stage 16-byte aligned
# columns with tensor-map loads
ALIGN = 8

# the collectives of the model axis since the last reset: halo exchanges
# (`exchange`) and whole-width gathers (`gather_width`), with the
# bytes each rank sent
COUNTS = {"exchanges": 0, "exchange_bytes": 0, "gathers": 0, "gather_bytes": 0}


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


def check_geometry(width: int, n: int, pyramid: int, trunk: int) -> None:
    """Raise ValueError unless `width` columns split into n shards that hold
    whole, even-aligned columns at every level: the width divisible by n x
    the pyramid factor x the trunk factor, and each shard at least as wide
    as the widest halo of every level, 3 at the coarsest pyramid level (the
    7x7 convs) and 2 at the coarsest trunk level (the residual blocks).
    JAX pads uneven shards; the port refuses them."""
    unit = n * pyramid * trunk
    least = max(2 * unit, 3 * n * pyramid)
    if width % unit or width < least:
        raise ValueError(
            f"width {width} on {n} ranks: the width must be a multiple of ranks x "
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
    on a side that is the image's edge or takes no halo. One all_gather over
    the shard's group of every rank's packed strips (B, C, H, left + right):
    for two ranks what a pairwise exchange sends."""
    w = x.shape[-1]
    if max(left, right) > w:
        raise ValueError(f"a halo of {max(left, right)} columns is wider than the shard's {w}")
    send = edge_strips(x, left, right)
    parts = [torch.empty_like(send) for _ in range(shard.n)]
    dist.all_gather(parts, send, group=shard.group)
    COUNTS["exchanges"] += 1
    COUNTS["exchange_bytes"] += send.numel() * send.element_size()
    lstrip = (None if shard.left_edge or left == 0
              else parts[shard.index - 1][..., right:])
    rstrip = (None if shard.right_edge or right == 0
              else parts[shard.index + 1][..., :right])
    return lstrip, rstrip


def gather_width(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The whole width of a tensor whose last dim is split in rank order
    over the n ranks of `group`, on every rank: one all_gather."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    COUNTS["gathers"] += 1
    COUNTS["gather_bytes"] += x.numel() * x.element_size()
    return torch.cat(parts, -1)


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
