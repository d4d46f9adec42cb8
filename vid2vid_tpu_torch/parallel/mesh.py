"""The device mesh on torch.distributed: the data axis and the model axis.

The port of vid2vid_tpu/parallel/mesh.py. The JAX package runs one process
over a ('data', 'model') mesh and lets GSPMD shard the batch over 'data'
and the width over 'model'. Here each device is a process (a rank) of one
torch.distributed group, ranks laid out data-major (rank = data index x
model + model index), and both axes are written out:

  - every rank holds the same weights (`replicated`: a broadcast from rank
    0) and takes its rows of the global batch (`shard_batch`);
  - the data axis: the loss engine's train-mode batch norms take the
    global batch's statistics (nn/layers.py::BatchNorm2d, through
    `all_reduce_sum` over `Mesh.group`, the data axis of this rank's model
    index), the face box the global batch's extents
    (models/loss_engine.py::face_region);
  - the model axis (parallel/halo.py): each rank of a row (`Mesh.
    model_group`) runs the generator on its columns of every frame, the
    layers exchanging halos and each scale's frame gathered whole; the
    generator's batch norms take their statistics over both axes
    (`Mesh.world_group`);
  - the model axis in training shards the discriminators, VGG and the
    losses too (models/loss_engine.py): each rank's loss is its share of
    the whole frame's, and the shards' losses sum to it;
  - the gradients (train/steps.py::_apply) are reduced in one flat f32
    bucket over the world before the grad norms and Adam: summed over the
    model axis (each rank's is its share's) and averaged over the data
    axis,
so a step on a data x model mesh computes what one process computes on
the whole batch at the whole width. Serving takes a mesh of data 1 x
model N (models/inference.py).

`launch` starts the ranks of one group as processes; `init_process_group`
joins one. Nothing here starts a process or opens a socket at import.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist

from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.collectives import all_reduce, group_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh over the ranks of one group: this rank's
    place in it; the groups of this rank's data axis (its column of the
    mesh: the ranks of its model index; None with data 1: nothing to
    reduce), of its model axis (its row; None with model 1) and of every
    rank (None for one rank)."""

    data: int
    model: int
    rank: int = 0
    world: int = 1
    group: object = None
    model_group: object = None
    world_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        """This rank's row block on the data axis (ranks are laid out
        data-major, as JAX's device array is reshaped (data, model))."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's column block on the model axis."""
        return self.rank % self.model


def make_mesh(n_devices: int | None = None, data: int | None = None) -> Mesh:
    """A ('data', 'model') mesh over n_devices ranks (default: the
    initialised group's world, else 1): `data` ranks on the data axis
    (default all of them), the remainder on the model axis. JAX's shape
    rule and assert (vid2vid_tpu/parallel/mesh.py:27-43)."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    n = n_devices or world
    if data is None:
        data = n
    model = n // data
    assert data * model == n, f"{data}x{model} != {n} devices"
    rank = dist.get_rank() if initialised else 0
    if not initialised or n == 1:
        return Mesh(data, model, rank, world)
    whole = dist.group.WORLD
    # every rank makes every row's and column's group, in one order, as
    # new_group asks
    rows = [whole if data == 1 else dist.new_group(list(range(r * model, (r + 1) * model)))
            for r in range(data)] if model > 1 else [None] * data
    cols = [whole if model == 1 else dist.new_group(list(range(c, n, model)))
            for c in range(model)] if data > 1 else [None] * model
    return Mesh(data, model, rank, world, cols[rank % model], rows[rank // model], whole)


def visible_devices(n_devices: int, device: torch.device) -> int:
    """The devices of an --n_devices mesh, by the JAX package's rule: n =
    min(n_devices, the devices visible), with its warning. A device is a
    rank of the initialised process group; without one, a visible card (the
    CPU takes any number of gloo ranks)."""
    if n_devices <= 1:
        return 1
    if dist.is_available() and dist.is_initialized():
        avail = dist.get_world_size()
    elif torch.device(device).type == "cuda":
        avail = torch.cuda.device_count()
    else:
        avail = n_devices
    n = min(n_devices, avail)
    if n < n_devices:
        print(f"WARNING: --n_devices {n_devices} requested but only "
              f"{avail} devices visible; using {n}")
    return n


def all_gather_width(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole width of a tensor whose last dim is split over the model
    axis, in rank order, on every rank of it (x itself with model 1): one
    all_gather."""
    if mesh.model == 1:
        return x
    n = mesh.model
    return halo.gather_width(x, halo.WidthShard(mesh.model_index, n, n * x.shape[-1],
                                                x.shape[-2], mesh.model_group))


def shard_batch(x: torch.Tensor, mesh: Mesh, batch_axis: int | None = 0) -> torch.Tensor:
    """This rank's rows of `x` along `batch_axis` (a view): the global batch
    split into `mesh.data` equal blocks. `batch_axis=None` keeps the whole
    batch on every rank, as JAX replicates a remainder batch that does not
    divide the data axis (vid2vid_tpu/train/loop.py:172-182)."""
    if batch_axis is None or mesh.data == 1:
        return x
    b = x.shape[batch_axis]
    if b % mesh.data:
        raise ValueError(f"batch {b} does not divide the data axis {mesh.data}")
    rows = b // mesh.data
    return x.narrow(batch_axis, mesh.data_index * rows, rows)


def weights_digest(*modules: torch.nn.Module) -> str:
    """A hash of the bytes of every parameter and buffer of `modules`, in
    order: equal digests mean equal weights, bit for bit (how the ranks of
    a data axis are checked to hold one model)."""
    h = hashlib.blake2b(digest_size=16)
    for module in modules:
        for t in list(module.parameters()) + list(module.buffers()):
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replicated(*modules: torch.nn.Module, group=None) -> None:
    """Every parameter and buffer of `modules` broadcast from rank 0 of
    `group` (default: the whole world), in place: one broadcast of one flat
    bucket per dtype. Nothing without an initialised group of more than one
    rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    group = dist.group.WORLD if group is None else group
    if group_size(group) == 1:
        return
    src = dist.get_global_rank(group, 0)
    by_dtype: dict = {}
    for module in modules:
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_dtype.values():
            bucket = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(bucket, src, group=group)
            offset = 0
            for t in tensors:
                t.copy_(bucket[offset : offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_mean(tensors: Sequence[torch.Tensor], group, divisor: int | None = None) -> None:
    """Each tensor replaced, in place, by its sum over the ranks of `group`
    divided by `divisor` (default: the group's size, the mean): one
    all-reduce of one flat f32 bucket (not one per tensor). Nothing with no
    group or a group of one."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    with torch.no_grad():
        bucket = torch.cat([t.reshape(-1).float() for t in tensors])
        all_reduce(bucket, group)
        bucket.div_(n if divisor is None else divisor)
        offset = 0
        for t in tensors:
            t.copy_(bucket[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward; the backward sums the incoming gradients
    over the ranks (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable (the
    identity with no group or a group of one)."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group` (not
    differentiable; `x` itself with no group)."""
    if group_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ------------------------------------------------------------ processes

# the collectives' timeout: a rank that waits longer for another raises
TIMEOUT_S = 600.0
# how long a rank that has sent its result may take to exit, whatever is
# left of the deadline (the interpreter's teardown takes seconds on a
# loaded machine)
EXIT_GRACE_S = 30.0


def init_process_group(
    rank: int, world: int, init_method: str = "env://", backend: str | None = None,
    device: torch.device | str = "cpu",
) -> None:
    """Join the default group as `rank` of `world`: nccl for a card, gloo
    on the CPU (unless `backend` says otherwise), with an explicit timeout
    on its collectives (TIMEOUT_S); on a card, that card becomes the
    current one."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )


def torchrun_rank() -> tuple[int, int, int] | None:
    """(RANK, WORLD_SIZE, LOCAL_RANK) when torchrun started this process,
    else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        return rank, world, int(os.environ.get("LOCAL_RANK", rank))
    return None


def _rank_main(rank, world, init_method, backend, device, threads, fn, args, results) -> None:
    """A launched rank: join the group, run fn(*args), put (rank, ok,
    pickled result or traceback) on the parent's queue."""
    if threads:
        torch.set_num_threads(threads)
    try:
        init_process_group(rank, world, init_method, backend, device)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(
    fn: Callable, world: int, args: tuple = (),
    devices: Sequence[torch.device | str] | None = None, backend: str | None = None,
    deadline_s: float = 3600.0, threads: int | None = None,
) -> list:
    """Run fn(*args) on `world` ranks of one group and return each rank's
    result, in rank order.

    The ranks are processes started with the spawn method (fn and args are
    pickled by reference and value: fn must be importable without the
    caller's test modules), joined through a file store in a new temporary
    directory (file://; no port to race other launches for), removed when
    they are done; rank
    r runs on devices[r] (default: cuda:r where there are cards, else the
    CPU), over `backend` (default: nccl on cards, gloo on the CPU), with
    `threads` intra-op threads if given. A result comes back pickled:
    tensors in it should be on the CPU. If a rank fails, or `deadline_s`
    passes first, every rank still running is killed and this raises: it
    never returns with fewer ranks.

    Under torchrun (RANK and WORLD_SIZE set) this process is one rank: it
    joins the group torchrun describes (env://, on cuda:LOCAL_RANK where
    there are cards) and returns [its own result]."""
    given = torchrun_rank()
    if given is not None:
        rank, n, local = given
        if n != world:
            raise RuntimeError(f"torchrun started {n} ranks; {world} were asked for")
        cards = torch.cuda.is_available()
        init_process_group(rank, n, "env://", backend, f"cuda:{local}" if cards else "cpu")
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()

    if devices is None:
        cards = torch.cuda.is_available()
        devices = [f"cuda:{r}" if cards else "cpu" for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rendezvous = tempfile.mkdtemp(prefix="v2v_launch_")
    init_method = "file://" + os.path.join(rendezvous, "store")
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            r, world, init_method, backend, str(devices[r]), threads, fn, args, results))
        for r in range(world)
    ]
    out, failure, dead_since = {}, None, {}
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                now = time.monotonic()
                if now > end:
                    failure = f"the deadline of {deadline_s:.0f} s passed"
                for r, p in enumerate(procs):
                    # a rank's report may still be in the pipe when it exits
                    if r not in out and p.exitcode is not None and (
                            now - dead_since.setdefault(r, now) > 2.0):
                        failure = f"rank {r} exited with code {p.exitcode} and no result"
                continue
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                failure = f"rank {rank} failed:\n{payload}"
        for p in procs:
            p.join(timeout=max(EXIT_GRACE_S, end - time.monotonic()) if failure is None
                   else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"launch of {world} ranks: {failure}")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"launch of {world} ranks: exit codes {bad}")
    return [out[r] for r in range(world)]
