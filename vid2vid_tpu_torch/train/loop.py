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
`models/flownet2/wrapper.py::FlowEstimator` does. The Trainer runs on the
first CUDA device unless the caller passes device='cpu'.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.models.loss_engine import LossEngine
from vid2vid_tpu_torch.models.temporal import (
    skipped_flows,
    skipped_frames,
    skipped_frames_sparse,
)
from vid2vid_tpu_torch.nn.layers import init_weights, update_running_stats
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


def zero_flow_fn(real_b: torch.Tensor, real_b_prev: torch.Tensor):
    """The no-flownet fallback: zero flow, full confidence."""
    b, t, _, h, w = real_b.shape
    return (torch.zeros((b, t, 2, h, w), device=real_b.device),
            torch.ones((b, t, 1, h, w), device=real_b.device))


class Trainer:
    """Owns the generator, the loss engine and the schedule."""

    def __init__(
        self, opt: Options, flow_fn: Callable | None = None,
        device: torch.device | str = "cuda",
    ):
        if opt.n_devices > 1:
            raise NotImplementedError(
                "--n_devices > 1 (the data / model mesh) is not ported "
                "(ROADMAP.md, queue 1: tools and multi-device)"
            )
        self.opt = opt
        self.device = require_device(device)
        self.gen = Vid2VidGenerator(opt).to(self.device).train()
        self.engine = LossEngine(opt).to(self.device).train()
        # the steps normalize with batch statistics and, as in the JAX
        # package, never update the running ones
        update_running_stats(self.gen, False)
        update_running_stats(self.engine, False)
        self.flow_fn = flow_fn or zero_flow_fn
        self.schedule = Schedule(opt)
        # the last chunk's ClipOutputs (detached) and its (labels, real_b,
        # flow_ref, conf_ref), for train_cli.py's visuals
        self.last_outs = None
        self.last_inputs = None

    # ------------------------------------------------------------------ setup

    def init_state(self) -> TrainState:
        """Weights from a torch.Generator seeded with opt.seed (the
        reference's weights_init), and fresh optimizers."""
        gen = torch.Generator().manual_seed(self.opt.seed)
        init_weights(self.gen, gen)
        init_weights(self.engine, gen)
        return create_train_state(self.opt, self.gen, self.engine)

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

        # reference flows for the chunk's current frames
        real_b_cur = real_b[:, tG - 1:]
        real_b_prev = real_b[:, tG - 2 : -1]
        flow_ref, conf_ref = self.flow_fn(real_b_cur, real_b_prev)

        # temporal real / flow buffers and groups
        if opt.sparse_D:
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
                    flow_skipped[s], _ = self.flow_fn(rb[:, 1:], rb[:, :-1])

        # G step
        loss_g, aux = g_step(
            state, opt, enc_a, real_b, carry.gen_state, flow_ref, conf_ref,
            carry.fake_prev_first, carry.fake_buf, real_skipped, flow_skipped,
            use_raw_only=use_raw_only, n_frames_bp=self.schedule.n_frames_bp,
            finetune_all=self.schedule.finetune_all, chunk_start=carry.chunk_start,
        )
        outs = aux["outs"]
        self.last_outs = outs
        self.last_inputs = (labels, real_b, flow_ref, conf_ref)
        carry.gen_state = aux["gen_state"]
        carry.fake_buf = aux["fake_buf"]
        carry.fake_prev_first = outs.fake[:, -1:]
        fake_skipped = aux["fake_skipped"]

        # D step
        loss_d, d_losses = d_step(
            state, opt, enc_a, real_b, outs.fake, None if use_raw_only else outs.raw)

        # temporal D steps
        dt_losses = []
        for s in range(t_scales):
            if real_skipped[s] is None or fake_skipped[s] is None:
                continue
            _, dtl = dt_step(state, opt, real_skipped[s], fake_skipped[s],
                             flow_skipped[s], scale=s)
            dt_losses.append(dtl)

        carry.chunk_start += n_load
        self.schedule.total_steps += opt.batchSize

        # ONE transfer for every loss scalar (the JAX package measured a
        # per-key readback at 2.7x the whole step's host cost)
        out = dict(aux["losses"])
        out["G_grad_norm"] = aux["grad_norm"]
        out.update(d_losses)
        for s, dtl in enumerate(dt_losses):
            out.update({f"{k}{s}": v for k, v in dtl.items()})
        for s, tl in enumerate(aux["t_losses"]):
            out.update({f"{k}{s}": v for k, v in tl.items()})
        out["loss_G_total"] = loss_g
        out["loss_D_total"] = loss_d
        values = torch.stack([v.float().reshape(()) for v in out.values()]).cpu()
        return state, carry, dict(zip(out, values.tolist()))

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
    `clips` yields (labels, real_b, inst) as train_clip takes them.
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
            enc_full = gen.encode_input(
                labels.to(dev), None if inst is None else inst.to(dev))
            real_b = real_b.to(dev, torch.float32)
            n_win = max(1, real_b.shape[1] - tG + 1)
            stride = max(1, -(-n_win // max_windows_per_clip))
            for t0 in range(0, n_win, stride):
                gen_state = gen.state_from_frames(real_b[:, t0 : t0 + tG - 1])
                gen.generate_clip(enc_full[:, t0 : t0 + tG], gen_state)
    finally:
        update_running_stats(gen, False)
        gen.train(was_training)
    return state
