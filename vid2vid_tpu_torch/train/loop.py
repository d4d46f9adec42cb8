"""Training orchestration: the per-clip chunk loop, the temporal buffers and
the curriculum.

The port of vid2vid_tpu/train/loop.py, with the reference's epoch -> clip
-> chunk structure (reference: train.py:37-128, data/base_dataset.py:56-80):

  for each clip (a (B, n_frames, ...) stack):
    reset the generator state and the temporal buffers;
    for each chunk of n_frames_load frames:
      - encode the inputs, compute the reference flows (`flow_fn`);
      - G step (generate + every G loss + Adam);
      - D step; one D_T step per active temporal scale;
      - carry the generator's ring buffers and the temporal buffers on.

Layouts: labels (B, T, H, W) integer ids (or (B, T, C, H, W) float maps),
frames (B, T, 3, H, W) in [-1, 1], flows (B, T, 2, H, W). `flow_fn(cur,
prev)` returns (flow, confidence) for two equal frame stacks, as
`models/flownet2/wrapper.py::FlowEstimator` does; on a model axis the
Trainer calls `flow_fn(cur, prev, shard=shard)`, the frames whole, for this
rank's columns of both. The Trainer runs on the first CUDA device unless
the caller passes device='cpu'.

With --n_devices N it is one rank of the JAX Trainer's mesh, data =
gcd(batchSize, N) x model = N / data (parallel/mesh.py): it keeps its data
rows of each global batch, and on a model axis it runs its columns of
every frame (a parallel/halo.py::WidthShard of the finest level; `shard`),
as the JAX mesh partitions every activation over the width: the
generator, netD, every netD_T, VGG, every loss (each rank's loss its
share of the whole frame's; the reported losses their sum) and the
reference flow (FlowNet2 and its confidence, computed on the rank's
columns by `flow_fn(..., shard=)` for the chunk and for each coarser
temporal scale). The real frames are sliced to the rank's columns; the
previous frames that the warps sample stay whole (the generator's whole
fakes, detached, and the real frames), and so do the frames FlowNet2
reads. The face discriminator runs whole on its crop, on every rank of a
row.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import ClipOutputs, Vid2VidGenerator
from vid2vid_tpu_torch.models.loss_engine import LossEngine
from vid2vid_tpu_torch.models.temporal import (
    skipped_flows,
    skipped_frames,
    skipped_frames_sparse,
)
from vid2vid_tpu_torch.nn.layers import init_weights, sync_batch_norm, update_running_stats
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    make_mesh,
    replicated,
    shard_batch,
    visible_devices,
)
from vid2vid_tpu_torch.train.state import (
    Schedule,
    TrainState,
    create_train_state,
    reinit_g_optimizer,
    set_learning_rate,
)
from vid2vid_tpu_torch.train.steps import d_step, dt_step, g_step
from vid2vid_tpu_torch.utils.device import require_device


@dataclasses.dataclass
class ClipCarry:
    """Cross-chunk state within one clip."""

    gen_state: Any = None
    fake_prev_first: Any = None  # (B, 1, 3, H, W) for the warp-consistency loss
    real_all: Any = None
    fake_buf: Any = None
    flow_all: Any = None
    conf_all: Any = None
    chunk_start: int = 0


def zero_flow_fn(real_b: torch.Tensor, real_b_prev: torch.Tensor,
                 shard: halo.WidthShard | None = None):
    """The no-flownet fallback: zero flow, full confidence (on a shard, at
    its columns)."""
    b, t, _, h, w = real_b.shape
    w = w if shard is None else shard.width
    return (torch.zeros((b, t, 2, h, w), device=real_b.device),
            torch.ones((b, t, 1, h, w), device=real_b.device))


def mesh_devices(opt: Options, device: torch.device) -> int:
    """The devices of --n_devices' mesh, by the JAX Trainer's rule
    (vid2vid_tpu/train/loop.py:87-98): parallel.mesh.visible_devices, with
    its warning."""
    return visible_devices(opt.n_devices, device)


def train_mesh(opt: Options, device: torch.device) -> Mesh | None:
    """The mesh of --n_devices (`mesh_devices`), as the JAX Trainer builds
    it: make_mesh(n, data=gcd(batchSize, n)), the remaining devices on the
    model axis; None for one device. Raises for n > 1 without a process
    group of world n."""
    n = mesh_devices(opt, device)
    if n == 1:
        return None
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != n:
        raise RuntimeError(
            f"--n_devices {n}: no process group of {n} ranks. Run train_cli with "
            f"--n_devices {n} (it starts the ranks), or torchrun --nproc_per_node {n}, "
            "or call vid2vid_tpu_torch.parallel.launch")
    return make_mesh(n, data=math.gcd(opt.batchSize, n))


class Trainer:
    """Owns the generator, the loss engine and the schedule. With
    --n_devices N > 1 it is one rank of the mesh of N (`train_mesh`): each
    rank takes its data rows of the global batch it is given and, on a
    model axis, runs the generator on its columns (`shard`)."""

    def __init__(
        self, opt: Options, flow_fn: Callable | None = None,
        device: torch.device | str = "cuda",
    ):
        self.opt = opt
        self.device = require_device(device)
        self.mesh = train_mesh(opt, self.device)
        # the data axis's group (the engine's norms and face box, the
        # losses' mean) and every rank's (the generator's norms, the
        # gradients' reduction)
        self.group = None if self.mesh is None else self.mesh.group
        self.world_group = None if self.mesh is None else self.mesh.world_group
        self.gen = Vid2VidGenerator(opt).to(self.device).train()
        self.engine = LossEngine(opt).to(self.device).train()
        # the steps normalize with batch statistics and, as in the JAX
        # package, never update the running ones
        update_running_stats(self.gen, False)
        update_running_stats(self.engine, False)
        # the norms of the generator and of the discriminators that a model
        # axis shards take their statistics over the global batch at the
        # whole width (every rank), the face D's (on the whole crop) over
        # the data axis; the face box spans every rank's frames and columns
        sync_batch_norm(self.gen, self.world_group)
        sync_batch_norm(self.engine, self.world_group)
        if self.engine.netD_f is not None:
            sync_batch_norm(self.engine.netD_f, self.group)
        self.engine.group = self.world_group
        self.flow_fn = flow_fn or zero_flow_fn
        self.schedule = Schedule(opt)
        # the last chunk's ClipOutputs (detached; on a model axis made whole,
        # `_whole_outputs`) and its (labels, real_b, flow_ref, conf_ref; the
        # flows whole too, `_whole_flows`), for train_cli.py's visuals
        self.last_outs = None
        self.last_inputs = None

    # ------------------------------------------------------------------ setup

    def init_state(self) -> TrainState:
        """Weights from a torch.Generator seeded with opt.seed (the
        reference's weights_init), broadcast from rank 0 on a mesh, and
        fresh optimizers."""
        gen = torch.Generator().manual_seed(self.opt.seed)
        init_weights(self.gen, gen)
        init_weights(self.engine, gen)
        if self.mesh is not None:
            replicated(self.gen, self.engine, group=self.world_group)
        return create_train_state(self.opt, self.gen, self.engine)

    def shard(self, width: int, height: int) -> halo.WidthShard | None:
        """This rank's columns of frames `width` x `height` on the model
        axis (None without one); raises ValueError for a width the ranks
        cannot split: not a multiple of them, as the JAX Trainer's
        device_put refuses (halo.check_geometry)."""
        if self.mesh is None or self.mesh.model == 1:
            return None
        n = self.mesh.model
        halo.check_geometry(width, n, user="training on the model axis")
        return halo.make_shard(self.mesh.model_index, n, width, self.mesh.model_group, height)

    def local_rows(self, x: torch.Tensor | None) -> torch.Tensor | None:
        """This rank's data rows of a global batch (all of it without a
        data axis; the ranks of a row share them). A remainder batch that
        does not divide the data axis stays whole on every rank, as JAX
        replicates it: the synchronised norms then see each sample once per
        rank, which leaves the mean and the biased variance as they are."""
        if x is None or self.mesh is None:
            return x
        return shard_batch(x, self.mesh, 0 if x.shape[0] % self.mesh.data == 0 else None)

    # ------------------------------------------------------------------ clip

    def start_clip(self) -> ClipCarry:
        return ClipCarry()

    def train_chunk(
        self, state: TrainState, carry: ClipCarry, labels: torch.Tensor,
        real_b: torch.Tensor, inst: torch.Tensor | None = None,
    ):
        """One optimization step over a chunk of t_len frames.

        Returns (state, carry, loss dict of floats), the losses read back
        from the card in one transfer.
        """
        opt = self.opt
        tG, t_scales, td = opt.n_frames_G, opt.n_scales_temporal, opt.n_frames_D
        dev = self.device
        labels, real_b, inst = (self.local_rows(x) for x in (labels, real_b, inst))
        labels, real_b = labels.to(dev), real_b.to(dev, torch.float32)
        inst = None if inst is None else inst.to(dev)
        first_chunk = carry.gen_state is None
        if opt.sparse_D and carry.fake_buf is None:
            carry.fake_buf = (None,) * t_scales

        enc_a = self.gen.encode_input(labels, inst)
        b, t_len, _, h, w = real_b.shape
        n_load = t_len - tG + 1

        # generator seed state (reference: vid2vid_model_G.py:231-251)
        use_raw_only = False
        if first_chunk:
            if opt.no_first_img:
                carry.gen_state = self.gen.zero_state(b, h, w, device=dev)
                use_raw_only = True
            else:
                carry.gen_state = self.gen.state_from_frames(real_b[:, : tG - 1])
            carry.fake_prev_first = real_b[:, tG - 2 : tG - 1]

        # reference flows for the chunk's current frames (on a model axis
        # this rank's columns of them, from the whole frames)
        shard = self.shard(w, h)
        real_b_cur = real_b[:, tG - 1:]
        real_b_prev = real_b[:, tG - 2 : -1]
        flow_ref, conf_ref = self._flows(real_b_cur, real_b_prev, shard)
        self.last_inputs = (labels, real_b, *self._whole_flows(flow_ref, conf_ref, shard))

        # temporal real / flow buffers and groups (the rank's columns; the
        # dense buffer of real frames stays whole: the coarser scales'
        # flows are computed on whole frames)
        if opt.sparse_D:
            real_b_cur = halo.local(real_b_cur, shard)
            if carry.real_all is None:
                carry.real_all = [None] * t_scales
                carry.flow_all = [None] * t_scales
                carry.conf_all = [None] * t_scales
            i0 = carry.chunk_start
            carry.real_all, real_skipped = skipped_frames_sparse(
                carry.real_all, real_b_cur, t_scales, td, n_load, i0)
            carry.flow_all, flow_skipped = skipped_frames_sparse(
                carry.flow_all, flow_ref, t_scales, td, n_load, i0, is_flow=True)
            carry.conf_all, _ = skipped_frames_sparse(
                carry.conf_all, conf_ref, t_scales, td, n_load, i0, is_flow=True)
        else:
            carry.real_all, real_skipped = skipped_frames(
                carry.real_all, real_b_cur, t_scales, td)
            carry.flow_all, carry.conf_all, flow_skipped, _ = skipped_flows(
                carry.flow_all, carry.conf_all, flow_ref, conf_ref, t_scales, td)
            # coarser temporal scales: the reference flow between the
            # skipped real frames (reference: vid2vid_model_D.py:292-302)
            for s in range(1, t_scales):
                rb = real_skipped[s]
                if rb is not None:
                    flow_skipped[s] = self._flows(rb[:, 1:], rb[:, :-1], shard)[0]
            real_skipped = [halo.local(r, shard) for r in real_skipped]
        divisor = None if self.mesh is None else self.mesh.data

        # G step
        loss_g, aux = g_step(
            state, opt, enc_a, real_b, carry.gen_state, flow_ref, conf_ref,
            carry.fake_prev_first, carry.fake_buf, real_skipped, flow_skipped,
            use_raw_only=use_raw_only, n_frames_bp=self.schedule.n_frames_bp,
            finetune_all=self.schedule.finetune_all, chunk_start=carry.chunk_start,
            group=self.world_group, divisor=divisor, shard=shard,
        )
        outs = aux["outs"]
        self.last_outs = outs if shard is None else self._whole_outputs(
            outs, aux["fake_whole"], shard)
        carry.gen_state = aux["gen_state"]
        carry.fake_buf = aux["fake_buf"]
        carry.fake_prev_first = aux["fake_whole"][:, -1:]
        fake_skipped = aux["fake_skipped"]

        # D step
        loss_d, d_losses = d_step(
            state, opt, enc_a, real_b, outs.fake, None if use_raw_only else outs.raw,
            group=self.world_group, divisor=divisor, shard=shard)

        # temporal D steps
        dt_losses = []
        for s in range(t_scales):
            if real_skipped[s] is None or fake_skipped[s] is None:
                continue
            _, dtl = dt_step(state, opt, real_skipped[s], fake_skipped[s],
                             flow_skipped[s], scale=s, group=self.world_group,
                             divisor=divisor, shard=shard)
            dt_losses.append(dtl)

        carry.chunk_start += n_load
        self.schedule.total_steps += opt.batchSize

        # ONE transfer for every loss scalar (the JAX package measured a
        # per-key readback at 2.7x the whole step's host cost), after one
        # all-reduce on a mesh: each loss summed over the model axis (each
        # rank holds its share) and averaged over the data axis; the grad
        # norms, of the reduced gradients, are the same on every rank
        out = dict(aux["losses"])
        out["G_grad_norm"] = aux["grad_norm"]
        out.update(d_losses)
        for s, dtl in enumerate(dt_losses):
            out.update({f"{k}{s}": v for k, v in dtl.items()})
        for s, tl in enumerate(aux["t_losses"]):
            out.update({f"{k}{s}": v for k, v in tl.items()})
        out["loss_G_total"] = loss_g
        out["loss_D_total"] = loss_d
        values = torch.stack([v.float().reshape(()) for v in out.values()])
        is_loss = torch.tensor(["_grad_norm" not in k for k in out], device=values.device)
        summed = values * is_loss
        all_reduce_mean([summed], self.world_group, divisor)
        values = torch.where(is_loss, summed, values)
        return state, carry, dict(zip(out, values.cpu().tolist()))

    def _flows(self, cur: torch.Tensor, prev: torch.Tensor, shard: halo.WidthShard | None):
        """flow_fn's (flow, confidence) of the frame pairs: on a model axis
        this rank's columns, computed there (`flow_fn(..., shard=)`)."""
        if shard is None:
            return self.flow_fn(cur, prev)
        return self.flow_fn(cur, prev, shard=shard)

    @staticmethod
    def _whole_flows(flow: torch.Tensor, conf: torch.Tensor,
                     shard: halo.WidthShard | None) -> tuple[torch.Tensor, torch.Tensor]:
        """A shard's reference flow and confidence made whole for the
        visuals: one all_gather, without a gradient."""
        if shard is None:
            return flow, conf
        with torch.no_grad():
            whole = halo.gather_width(torch.cat([flow, conf.to(flow.dtype)], 2), shard)
        return whole[:, :, :2], whole[:, :, 2:].to(conf.dtype)

    @staticmethod
    def _whole_outputs(outs: ClipOutputs, fake_whole: torch.Tensor,
                       shard: halo.WidthShard) -> ClipOutputs:
        """A shard's ClipOutputs made whole for the visuals: the whole fakes,
        and the last frame of raw, flow and weight (those that exist: flow
        and weight come together) gathered by one all_gather."""
        parts = [t[:, -1:] for t in (outs.raw, outs.flow, outs.weight) if t is not None]
        whole = halo.gather_width(torch.cat(parts, 2), shard).split(
            [t.shape[2] for t in parts], 2)
        raw, flow, weight = (*whole, None, None)[:3]
        return ClipOutputs(fake_whole, raw, flow, weight)

    def train_clip(self, state, labels, real_b, inst=None):
        """Every chunk of one clip; returns (state, the last loss dict)."""
        tG = self.opt.n_frames_G
        n_total = labels.shape[1]  # includes the tG-1 warm-up frames
        n_load = min(self.schedule.n_frames_load, n_total - tG + 1)
        t_len = n_load + tG - 1
        carry = self.start_clip()
        losses = {}
        for i in range(0, n_total - t_len + 1, n_load):
            state, carry, losses = self.train_chunk(
                state, carry, labels[:, i : i + t_len], real_b[:, i : i + t_len],
                None if inst is None else inst[:, i : i + t_len],
            )
        return state, losses

    # ------------------------------------------------------------------ epoch

    def end_of_epoch(self, state: TrainState) -> TrainState:
        """LR decay, curriculum growth, scale unfreeze."""
        events = self.schedule.end_of_epoch()
        if events["unfreeze"]:
            state = reinit_g_optimizer(state, self.opt)
        return set_learning_rate(state, self.opt, self.schedule.lr_factor())


@torch.no_grad()
def refresh_batch_stats(
    trainer: Trainer, state: TrainState, clips, n_batches: int = 8,
    max_windows_per_clip: int = 8,
) -> TrainState:
    """Recalibrate the generator's norm running statistics for eval.

    Training normalizes with per-batch statistics and never updates the
    running ones, so a generator trained from scratch needs this pass before
    eval-mode inference: the generator runs forward in train mode, each norm
    updating its running stats (momentum 0.1, unbiased variance), over up to
    `max_windows_per_clip` tG-frame windows of each of `n_batches` clips.
    `clips` yields (labels, real_b, inst) as train_clip takes them. On a
    mesh every rank runs this on its rows (and columns, on a model axis),
    and the synchronised norms take the global batch's statistics at the
    whole width, so the ranks' running stats agree.
    """
    gen, tG = trainer.gen, trainer.opt.n_frames_G
    norms = update_running_stats(gen, True)
    if not norms:
        return state  # norm='none': nothing to recalibrate
    dev = trainer.device
    was_training = gen.training
    gen.train()
    try:
        for count, (labels, real_b, inst) in enumerate(clips):
            if count >= n_batches:
                break
            labels, real_b, inst = (trainer.local_rows(x) for x in (labels, real_b, inst))
            enc_full = gen.encode_input(
                labels.to(dev), None if inst is None else inst.to(dev))
            real_b = real_b.to(dev, torch.float32)
            n_win = max(1, real_b.shape[1] - tG + 1)
            stride = max(1, -(-n_win // max_windows_per_clip))
            shard = trainer.shard(real_b.shape[-1], real_b.shape[-2])
            for t0 in range(0, n_win, stride):
                gen_state = gen.state_from_frames(real_b[:, t0 : t0 + tG - 1])
                gen.generate_clip(enc_full[:, t0 : t0 + tG], gen_state, shard=shard)
    finally:
        update_running_stats(gen, False)
        gen.train(was_training)
    return state
