"""Entry functions for the ranks that tests/test_torch_parallel.py,
tests/test_torch_shard_serve.py and tests/test_torch_cuda.py start through
vid2vid_tpu_torch.parallel.launch.

A spawned rank imports the module of the function it runs, so this one
imports torch and the port and nothing of JAX (a test module does). Each
function takes numpy arrays or CPU tensors and returns CPU values.

  - `train_chunks`: a Trainer on this rank's rows of a global clip, chunk by
    chunk (parallel/workers.py::run_chunks), with the stub flow or a
    seeded FlowEstimator (`flow="flownet2"`);
  - `batch_norm_rows`: one synchronised BatchNorm2d forward and backward on
    this rank's rows;
  - `train_cli_rank`: train_cli's rank (train_cli.train_rank);
  - `shard_serve`: the width-sharded InferenceEngine (the model axis)
    through generate_clip_raw and the step loop, and the test CLI's rank;
  - `loaded_packages`: what the rank has imported;
  - `run_all`: several of these in one launch, in order.

`fault=` applies one named defect of the data axis in this rank, so that a
test can show that its bounds see it: `unsynced_norms` (batch norm on the
rank's rows alone), `summed_gradients` (the gradients summed over the ranks
instead of averaged: train/steps.py's `all_reduce_mean` replaced for the
call), `face_box_per_rank` (each rank crops the face at its own box) and,
for the CLI, `rank0_rows` (every rank trains on rank 0's rows). The model
axis's (`SHARD_FAULTS`, undone after the call): `halo_wrong_side` (each
kernel's left halo reads the columns past the shard's right side and its
right halo those before its left), `reflect_inner_edges` (every shard
reflects at its inner sides as at the image's edges) and `warp_no_offset`
(the warp samples the whole previous frame at the shard's local columns);
in training (`TRAIN_SHARD_FAULTS`), `halo_grad_dropped` (the exchanges'
backward keeps each rank's own reads' gradient and drops the halos', on
every rank), `d_grads_averaged` (netD's and netD_T's gradients averaged
over the model axis, not summed: the D steps' `divisor` dropped) and
`local_loss_means` (each rank's losses the means of its own columns:
losses.py's `share_mean` replaced by torch.mean). `train_chunks` also
reports the widths that netD's finest layer saw (`d_widths`).
"""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist

from vid2vid_tpu_torch import losses, test_cli, train_cli
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.flownet2.nets import init_flownet_weights
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn import composite
from vid2vid_tpu_torch.nn.layers import BatchNorm2d, sync_batch_norm
from vid2vid_tpu_torch.parallel import halo, mesh
from vid2vid_tpu_torch.losses import share_mean
from vid2vid_tpu_torch.parallel.workers import deterministic_algorithms, run_chunks
from vid2vid_tpu_torch.train import loop, steps
from vid2vid_tpu_torch.train.loop import Trainer

FAULTS = ("unsynced_norms", "summed_gradients", "face_box_per_rank")
SHARD_FAULTS = ("halo_wrong_side", "reflect_inner_edges", "warp_no_offset")
TRAIN_SHARD_FAULTS = ("halo_grad_dropped", "d_grads_averaged", "local_loss_means")


def stub_flow(cur: torch.Tensor, prev: torch.Tensor, shard: halo.WidthShard | None = None):
    """A deterministic stand-in for FlowNet2 on (B, T, 3, H, W) frames
    (tests/test_train_oracle.py's); on a width shard, its columns."""
    d = halo.local(cur - prev, shard)
    flow = torch.stack([2.0 * torch.tanh(3.0 * d[:, :, 0]),
                        2.0 * torch.tanh(3.0 * d[:, :, 1])], 2)
    return flow, torch.sigmoid(d[:, :, 2:3])


def _tensor(x):
    return None if x is None else torch.as_tensor(x)


def _all_reduce_sum_in_place(tensors, group, divisor=None) -> None:
    """The `summed_gradients` fault: all_reduce_mean without the mean."""
    if mesh.group_size(group) > 1:
        for t in tensors:
            dist.all_reduce(t, group=group)


def seeded_flow_estimator(seed: int = 0) -> FlowEstimator:
    """FlowEstimator with the reference flow nets' init from a seeded
    torch.Generator (the same on every rank)."""
    est = FlowEstimator()
    init_flownet_weights(est, torch.Generator().manual_seed(seed))
    return est.eval()


def train_chunks(opt_kwargs: dict, labels, frames, inst=None, *, n_load: int,
                 device: str = "cpu", weights: tuple | None = None,
                 fault: str | None = None, deterministic: bool = False,
                 n_frames_bp: int | None = None, flow: str = "stub") -> dict:
    """A Trainer of Options(**opt_kwargs) on `device` with the stub flow
    (or with flow="flownet2" `seeded_flow_estimator`), with `weights`
    ((generator, engine) state dicts) if given, trained on the global clip
    (labels, frames, inst) chunk by chunk (`run_chunks`, under
    `deterministic_algorithms` if asked), its BPTT cadence `n_frames_bp` if
    given; run_chunks' result with `d_widths`, the input widths that
    netD's finest layer saw, and `flow_widths`, the widths of the flows
    flow_fn returned."""
    if fault is not None and fault not in FAULTS + TRAIN_SHARD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS + TRAIN_SHARD_FAULTS}")
    fetch_backward = halo._Fetch.backward
    if fault == "halo_grad_dropped":
        def local_part(ctx, g):  # the halos' gradients zeroed before they are sent
            g = g.clone()
            g[..., ctx.plan.halos[ctx.q]] = 0
            return fetch_backward(ctx, g)

        halo._Fetch.backward = staticmethod(local_part)
    elif fault == "d_grads_averaged":
        def averaged(step):
            return lambda *args, **kwargs: step(*args, **{**kwargs, "divisor": None})

        loop.d_step, loop.dt_step = averaged(steps.d_step), averaged(steps.dt_step)
    elif fault == "local_loss_means":
        losses.share_mean = lambda x, total=None: torch.mean(x)
    flow_fn = {"stub": stub_flow, "flownet2": seeded_flow_estimator}[flow]
    if flow == "flownet2":
        flow_fn = flow_fn().to(device)
    flow_widths = set()

    def recorded_flow(*args, **kwargs):
        out = flow_fn(*args, **kwargs)
        flow_widths.add(out[0].shape[-1])
        return out

    trainer = Trainer(Options(**opt_kwargs), flow_fn=recorded_flow, device=device)
    finest = getattr(trainer.engine.netD, f"scale{trainer.opt.num_D - 1}_layer0")[0]
    d_widths = set()
    finest.register_forward_pre_hook(lambda m, args: d_widths.add(args[0].shape[-1]))
    if n_frames_bp is not None:
        trainer.schedule.n_frames_bp = n_frames_bp
    state = trainer.init_state()
    if weights is not None:
        trainer.gen.load_state_dict({k: _tensor(v) for k, v in weights[0].items()})
        trainer.engine.load_state_dict({k: _tensor(v) for k, v in weights[1].items()})
    if fault == "unsynced_norms":
        sync_batch_norm(trainer.gen, None)
        sync_batch_norm(trainer.engine, None)
    elif fault == "face_box_per_rank":
        trainer.engine.group = None
    elif fault == "summed_gradients":
        steps.all_reduce_mean = _all_reduce_sum_in_place
    try:
        with deterministic_algorithms() if deterministic else contextlib.nullcontext():
            out = run_chunks(trainer, state, _tensor(labels), _tensor(frames),
                             _tensor(inst), n_load)
        return {**out, "d_widths": sorted(d_widths), "flow_widths": sorted(flow_widths)}
    finally:
        steps.all_reduce_mean = mesh.all_reduce_mean
        halo._Fetch.backward = staticmethod(fetch_backward)
        loop.d_step, loop.dt_step = steps.d_step, steps.dt_step
        losses.share_mean = share_mean


def batch_norm_rows(x, weight, bias, grad_out, update_stats: bool) -> dict:
    """A train-mode BatchNorm2d synchronised over the world, on this rank's
    rows of the global (N, C, H, W) batch `x`, its forward and its backward
    of `grad_out`'s rows: {"y", "dx"} (this rank's rows), {"dweight",
    "dbias"} (this rank's share: the global ones are their sum), and the
    running stats after the forward (updated while `update_stats`)."""
    m = mesh.make_mesh()
    x = mesh.shard_batch(torch.as_tensor(x), m).clone().requires_grad_(True)
    g = mesh.shard_batch(torch.as_tensor(grad_out), m)
    norm = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(weight))
        norm.bias.copy_(torch.as_tensor(bias))
    norm.update_stats = update_stats
    sync_batch_norm(norm, m.group)
    norm.train()
    y = norm(x)
    dx, dw, db = torch.autograd.grad(y, (x, norm.weight, norm.bias), g)
    return {"y": y.detach(), "dx": dx, "dweight": dw, "dbias": db,
            "running_mean": norm.running_mean.clone(), "running_var": norm.running_var.clone()}


def train_cli_rank(opt: Options, fault: str | None = None) -> dict:
    """train_cli.train_rank on this rank; with fault "rank0_rows" every rank
    keeps rank 0's rows of each global batch in place of its own."""
    if fault not in (None, "rank0_rows"):
        raise ValueError(f"unknown CLI fault {fault!r}")
    if fault == "rank0_rows":
        def rank0_rows(self, x):
            if x is None or self.mesh is None:
                return x
            return x.narrow(0, 0, x.shape[0] // self.mesh.data)

        Trainer.local_rows = rank0_rows
    return train_cli.train_rank(opt)


@contextlib.contextmanager
def _shard_fault(fault: str | None):
    """One of SHARD_FAULTS in this rank within the block (None: none)."""
    saved = [(halo, "_halo_columns", halo._halo_columns),
             (halo.WidthShard, "edges", halo.WidthShard.edges),
             (composite, "warp_blend_at", composite.warp_blend_at)]
    if fault == "halo_wrong_side":
        halo._halo_columns = lambda x0, x1, left, right: (range(x1, x1 + left),
                                                          range(x0 - right, x0))
    elif fault == "reflect_inner_edges":
        halo.WidthShard.edges = property(lambda self: halo.BOTH_EDGES)
    elif fault == "warp_no_offset":
        at = composite.warp_blend_at
        composite.warp_blend_at = lambda raw, prev, flow, weight, x0: at(
            raw, prev, flow, weight, 0)
    elif fault is not None:
        raise ValueError(f"unknown shard fault {fault!r}; one of {SHARD_FAULTS}")
    halo._plan.cache_clear()
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
        halo._plan.cache_clear()


def shard_serve(opt_kwargs: dict, weights: dict, labels, inst=None, *,
                fault: str | None = None) -> dict:
    """A width-sharded InferenceEngine of Options(**opt_kwargs) (its
    n_devices this launch's world) on the CPU, with the generator's
    `weights` on rank 0 only (the engine broadcasts them), serving the clip
    (labels, inst) of T + tG - 1 frames from a zero state: generate_clip_raw
    ("clip": fake, raw, flow, weight and the state, with the model axis's
    collectives counted), the step loop over its windows ("steps") and
    generate_clip on the encoded clip ("encoded": its frames)."""
    with _shard_fault(fault):
        return _shard_serve(opt_kwargs, weights, labels, inst)


def _shard_serve(opt_kwargs: dict, weights: dict, labels, inst) -> dict:
    eng = InferenceEngine(Options(**opt_kwargs), device="cpu")
    if torch.distributed.get_rank() == 0:
        eng.load_state_dict({k: _tensor(v) for k, v in weights.items()})
    labels, inst = _tensor(labels), _tensor(inst)
    b, _, h, w = labels.shape[:2] + labels.shape[-2:]
    tg = eng.opt.n_frames_G
    halo.reset_counts()
    outs, state = eng.generate_clip_raw(labels, inst, eng.initial_state(b, h, w))
    counts = dict(halo.COUNTS)
    steps, st = [], eng.initial_state(b, h, w)
    for t in range(labels.shape[1] - tg + 1):
        frame, st = eng.step(labels[:, t : t + tg], None if inst is None else inst[:, t : t + tg],
                             st)
        steps.append(frame)
    encoded = eng.generate_clip(eng.encode(labels, inst), eng.initial_state(b, h, w))[0].fake
    return {"clip": outs._asdict(), "state": state, "steps": torch.stack(steps, 1),
            "encoded": encoded, "counts": counts,
            "columns": (eng.shard(w, h).x0, eng.shard(w, h).width)}


def test_cli_rank(opt: Options) -> int:
    """test_cli's rank (test_cli.run_rank)."""
    return test_cli.run_rank(opt)


def loaded_packages() -> list[str]:
    """The top-level packages this rank has imported (a rank of the port
    imports no JAX and nothing of the JAX package)."""
    return sorted({name.split(".")[0] for name in sys.modules})


def run_all(calls: list) -> list:
    """Each (function name of this module, args, kwargs) called in order in
    one launch; returns their results."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in calls]
