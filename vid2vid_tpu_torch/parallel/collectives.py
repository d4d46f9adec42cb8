"""The collectives the mesh's layers call, over a torch.distributed group or
over a `LocalGroup`: N shards of one process, each on its own thread.

`LocalGroup` is the one-process plain version of a group of N ranks: its
all_gather and all_reduce meet the N threads at a barrier and answer in
memory, so that N shards of a layer (or of a whole generator scale, with
its backward) can be held against the whole tensor without processes. A
thread joins it as shard i with `member(i)`; the autograd backward of a CPU
graph runs on the thread that calls it, so a thread's backward takes its
collectives as that member too.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

# a LocalGroup's threads wait this long for each other at a collective
# before it raises (a thread that failed never arrives)
LOCAL_TIMEOUT_S = 120.0


class LocalGroup:
    """A group of n shards of one process, one thread each (`member`)."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=LOCAL_TIMEOUT_S)
        self._slots: list = [None] * n
        self._member = threading.local()

    @contextlib.contextmanager
    def member(self, rank: int):
        """This thread is shard `rank` of the group within the block."""
        self._member.rank = rank
        try:
            yield
        finally:
            del self._member.rank

    @property
    def rank(self) -> int:
        return self._member.rank

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every member's t, in rank order (copies)."""
        self._slots[self.rank] = t.detach().clone()
        self._barrier.wait()
        out = [s.clone() for s in self._slots]
        self._barrier.wait()  # no member writes its next slot before all have read
        return out


def group_size(group) -> int:
    """The ranks of `group` (1 for None: no group)."""
    if group is None:
        return 1
    if isinstance(group, LocalGroup):
        return group.n
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in `group` (0 for None)."""
    if group is None:
        return 0
    if isinstance(group, LocalGroup):
        return group.rank
    return dist.get_rank(group)


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's t (of one shape), in rank order: one all_gather."""
    if isinstance(group, LocalGroup):
        return group.all_gather(t)
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_reduce(t: torch.Tensor, group) -> None:
    """t replaced, in place, by its sum over the ranks of `group`."""
    if isinstance(group, LocalGroup):
        parts = group.all_gather(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        t.copy_(total)
        return
    dist.all_reduce(t, group=group)
