"""The sequential, scale-stacked video generator (inference and training).

A stack of `n_scales_spatial` generators: G0 = CompositeGenerator at the
coarsest pyramid level, G1.. = CompositeLocalGenerator enhancers at finer
levels with ngf halved per scale. Frames are generated strictly in order,
each conditioned on the tG-1 frames generated before it, coarse to fine
within a frame with features passed upward. The JAX package's `lax.scan`
over frames is a Python loop here.

Layouts: encoded clips are (B, T, C, H, W); the state is one
(B, tG-1, 3, H, W) ring buffer of previous frames per pyramid level, finest
first.

Two clip entry points: `generate_clip` takes a clip that is already
encoded (the training steps' path); `generate_clip_streaming` takes the raw
labels and encodes one frame per step into a window kept on the
generator's device, so the clip's encoded pyramid never exists whole.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.nn.composite import CompositeOut
from vid2vid_tpu_torch.nn.factory import define_g
from vid2vid_tpu_torch.ops.encode import (
    fg_mask_from_onehot,
    instance_edges,
    label_one_hot,
)
from vid2vid_tpu_torch.ops.pool import build_pyramid_video

State = tuple[torch.Tensor, ...]


class ClipOutputs(NamedTuple):
    """Per-clip outputs at the finest scale, (B, T, C, H, W) each.

    fake: blended frames; raw: hallucinated frames; flow / weight: (B, T,
    2 / 1, H, W), or None when the generator has no flow branch.
    """

    fake: torch.Tensor
    raw: torch.Tensor
    flow: torch.Tensor | None
    weight: torch.Tensor | None


def stack_time(x: torch.Tensor) -> torch.Tensor:
    """(B, K, C, H, W) -> (B, K*C, H, W), time-major channel blocks — the
    reference's `.view(b, -1, h, w)`, so checkpoints see its channel order."""
    b, k, c, h, w = x.shape
    return x.reshape(b, k * c, h, w)


def unstack_time(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, K*C, H, W) -> (B, K, C, H, W) — the inverse of stack_time."""
    b, kc, h, w = x.shape
    return x.reshape(b, k, kc // k, h, w)


class Vid2VidGenerator(nn.Module):
    """The scale stack, with the scale generators as submodules G0..G{n-1}."""

    def __init__(self, opt: Options):
        super().__init__()
        self.opt = opt
        self.n_scales = opt.n_scales_spatial
        self.tG = opt.n_frames_G
        self.add_module("G0", define_g(opt, opt.netG))
        for s in range(1, self.n_scales):
            self.add_module(
                f"G{s}",
                define_g(opt, "compositeLocal", ngf=opt.ngf_at_scale(s), scale=s),
            )

    def scale(self, s: int) -> nn.Module:
        return getattr(self, f"G{s}")

    # ------------------------------------------------------------------ input

    def encode_input(
        self, labels: torch.Tensor, inst: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Raw per-frame conditioning -> (B, T, gen_input_nc, H, W).

        labels: (B, T, H, W) integer label maps when label_nc > 0, else
        (B, T, input_nc, H, W) float maps. inst: (B, T, H, W) instance ids,
        appended as an edge channel when use_instance.
        """
        opt = self.opt
        enc = label_one_hot(labels, opt.label_nc) if opt.label_nc > 0 else labels
        if opt.use_instance:
            enc = torch.cat([enc, instance_edges(inst).unsqueeze(2)], dim=2)
        return enc

    # ------------------------------------------------------------------ state

    def state_from_frames(self, frames: torch.Tensor) -> State:
        """Ring buffers from (B, tG-1, 3, H, W) seed frames, finest first."""
        return tuple(build_pyramid_video(frames, self.n_scales))

    def zero_state(
        self, batch: int, height: int, width: int,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> State:
        """The no_first_img seed: all-zero previous frames."""
        z = torch.zeros(
            (batch, self.tG - 1, self.opt.output_nc, height, width),
            device=device, dtype=dtype,
        )
        return self.state_from_frames(z)

    # ------------------------------------------------------------------ clip

    def generate_clip(
        self, enc_a: torch.Tensor, state: State, *, use_raw_only: bool = False,
        train: bool = False, n_frames_bp: int = 1, finetune_all: bool = True,
        params: list[dict] | None = None,
    ) -> tuple[ClipOutputs, State]:
        """T frames, in order, from T+tG-1 encoded inputs (B, T+tG-1, C, H, W)
        and the per-level ring buffers. Returns (ClipOutputs, new state).

        Training (`train`): truncated BPTT detaches the previous frames that
        enter the frame pass every `n_frames_bp` frames (reference:
        vid2vid_model_G.py:166-168) while the ring buffers keep the
        gradient-connected frames; without `finetune_all` every scale but
        the finest is detached (:181); under `opt.remat` each scale's
        forward is recomputed in the backward (torch.utils.checkpoint).
        `params`, one dict per scale, replaces the scales' parameters for
        the call (the training steps' bf16 copies of the f32 masters). The
        new state is detached: it crosses the chunk boundary.
        """
        tG, n_scales = self.tG, self.n_scales
        n_frames = enc_a.shape[1] - (tG - 1)
        a_pyr = build_pyramid_video(enc_a, n_scales)
        bufs = tuple(stack_time(s) for s in state)
        ys = []
        for t in range(n_frames):
            wins = [p[:, t : t + tG] for p in a_pyr]
            detach = train and n_frames_bp > 0 and t % n_frames_bp == 0
            bufs, y = self._frame_pass(
                wins, bufs, use_raw_only, detach_prev=detach,
                detach_coarse=train and not finetune_all,
                remat=train and self.opt.remat, params=params,
            )
            ys.append(y)
        return self._clip_result(ys, bufs)

    @torch.no_grad()
    def generate_clip_streaming(
        self, labels: torch.Tensor, inst: torch.Tensor | None, state: State, *,
        use_raw_only: bool = False, compute_dtype: torch.dtype | None = None,
    ) -> tuple[ClipOutputs, State]:
        """Inference clip from the RAW conditioning, encoding one frame per
        step: the same frames as `encode_input` + `generate_clip`, without
        the clip's encoded pyramid (at 2048x1024 the 36-channel pyramid of
        one bf16 frame is ~200 MB, so a clip's is GBs).

        labels: (B, T+tG-1, H, W) integer maps, or (B, T+tG-1, C, H, W)
        float maps when label_nc == 0; inst: (B, T+tG-1, H, W) or None.
        They may lie on the host: one frame a step moves to the
        generator's device. Each encoded frame is cast to `compute_dtype`
        before its pyramid, as the JAX package does. Per level the last tG
        encoded frames live in a ring of 2 tG slots on the device: frame k
        is written to slots k % tG and k % tG + tG, so the window of frames
        k-tG+1..k is the contiguous slice from slot (k+1) % tG and no frame
        is copied again. Inference only (no BPTT).
        """
        tG, n_scales = self.tG, self.n_scales
        device = next(self.parameters()).device
        n_frames = labels.shape[1] - (tG - 1)

        def encode_frame(t: int) -> list[torch.Tensor]:
            enc = self.encode_input(
                labels[:, t : t + 1].to(device),
                None if inst is None else inst[:, t : t + 1].to(device),
            )
            if compute_dtype is not None:
                enc = enc.to(compute_dtype)
            return build_pyramid_video(enc, n_scales)

        rings: list[torch.Tensor] = []

        def push(k: int) -> list[torch.Tensor]:
            """Encode frame k into the rings; the windows ending at it."""
            pyr = encode_frame(k)
            if not rings:  # the slots before frame 0 are never read
                rings.extend(p.new_zeros((p.shape[0], 2 * tG) + p.shape[2:]) for p in pyr)
            for ring, p in zip(rings, pyr):
                ring[:, k % tG] = p[:, 0]
                ring[:, k % tG + tG] = p[:, 0]
            s = (k + 1) % tG
            return [ring[:, s : s + tG] for ring in rings]

        for k in range(tG - 1):
            push(k)
        bufs = tuple(stack_time(s) for s in state)
        ys = []
        for t in range(n_frames):
            bufs, y = self._frame_pass(push(t + tG - 1), bufs, use_raw_only)
            ys.append(y)
        return self._clip_result(ys, bufs)

    def _clip_result(self, ys: list, bufs: tuple) -> tuple[ClipOutputs, State]:
        """The frame passes' outputs stacked over time, and the new state
        (detached: it crosses the chunk boundary)."""
        fake, raw, flow, weight = (
            None if ys[0][i] is None else torch.stack([y[i] for y in ys], 1)
            for i in range(4)
        )
        new_state = tuple(unstack_time(b, self.tG - 1).detach() for b in bufs)
        return ClipOutputs(fake, raw, flow, weight), new_state

    def _apply_scale(self, s: int, params: dict | None, *args) -> CompositeOut:
        if params is None:
            return self.scale(s)(*args)
        return torch.func.functional_call(self.scale(s), params, args)

    def _frame_pass(
        self, wins, bufs, use_raw_only, *, detach_prev=False,
        detach_coarse=False, remat=False, params=None,
    ):
        """One frame through the coarse-to-fine scale stack.

        wins: per-level (B, tG, C, H, W) encoded windows, finest first;
        bufs: per-level channel-stacked (B, (tG-1)*3, H, W) ring buffers.
        Returns (new bufs, (fake, raw, flow, weight)).
        """
        opt = self.opt
        tG, n_scales = self.tG, self.n_scales
        c_out = opt.output_nc
        bufs_in = tuple(b.detach() for b in bufs) if detach_prev else bufs
        coarse: CompositeOut | None = None
        new_bufs = list(bufs)
        for s in range(n_scales):
            si = n_scales - 1 - s
            win = wins[si]
            lab = stack_time(win)
            # the fg mask comes from the POOLED one-hot of the window's last
            # frame at this level
            mask = fg_mask_from_onehot(win[:, tG - 1], opt.fg_labels) if opt.fg else None
            args = (lab, bufs_in[si]) + ((coarse,) if s else ()) + (mask, use_raw_only)
            p = None if params is None else params[s]
            if remat:
                out = checkpoint(self._apply_scale, s, p, *args, use_reentrant=False)
            else:
                out = self._apply_scale(s, p, *args)
            if detach_coarse and s != n_scales - 1:
                out = CompositeOut(*(None if x is None else x.detach() for x in out))
            coarse = out
            # ring buffer: drop the oldest frame, append this one (the
            # stored, gradient-connected frames)
            new_bufs[si] = torch.cat([bufs[si][:, c_out:], out.img_final], 1)
        return tuple(new_bufs), (coarse.img_final, coarse.img_raw, coarse.flow, coarse.weight)
