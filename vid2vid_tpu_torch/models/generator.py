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

On the model axis (`shard`, a parallel/halo.py::WidthShard of the finest
level: the engine's or the trainer's --n_devices N) each rank holds its
columns of every level, each level split by its own rule. It encodes the
columns of the raw labels that its pyramid levels are pooled from
(`pyramid_columns`, `encode_shard`: one more a side for the instance
edges; none past the image's edges, so the pools' border divisors stay
right), runs the scales on its columns under `halo.sharded` (the
layers exchange their halos), and after each scale gathers the whole frame
(one all_gather) into the previous frames, which every rank keeps whole:
the warp reads the whole previous frame, the previous-frame trunk its
columns of it, and the finest frame is whole for the caller. In training
the gathers and the exchanges carry the gradient back (parallel/halo.py's
gradient invariant), and under remat each scale's recompute in the
backward runs under the shard too, making the same exchanges in the same
order on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.nn.composite import CompositeOut
from vid2vid_tpu_torch.nn.factory import define_g
from vid2vid_tpu_torch.ops.encode import (
    fg_mask_from_onehot,
    instance_edges,
    label_one_hot,
)
from vid2vid_tpu_torch.ops.pool import avg_pool_3x3s2, build_pyramid_video
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.halo import WidthShard
from vid2vid_tpu_torch.utils.profiling import INPUT, span

State = tuple[torch.Tensor, ...]


class ClipOutputs(NamedTuple):
    """Per-clip outputs at the finest scale, (B, T, C, H, W) each.

    fake: blended frames; raw: hallucinated frames; flow / weight: (B, T,
    2 / 1, H, W), or None when the generator has no flow branch. From a
    width shard's training clip (`generate_clip(..., local=True)`) they
    are this rank's columns.
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

    def pyramid_columns(self, shard: WidthShard) -> list[tuple[int, int]]:
        """The columns [lo, hi) of each pyramid level, finest first, from
        which the shard's columns of every level are pooled: the coarsest
        level's are its own; level l's hold its own and those that the
        3x3/s2 pools of level l + 1's read, 2a - 1 .. 2b - 1 for [a, b),
        from an even column on (the pool's windows are centred on level
        l's even columns), with one more on the left, which is not read:
        the window of a slice's first output column that does not start at
        the image's edge lacks its left column, so that output is dropped."""
        cols = [shard.at(self.n_scales - 1).bounds(shard.index)]
        for level in range(self.n_scales - 2, -1, -1):
            sh = shard.at(level)
            (a, b), (x0, x1) = cols[0], sh.bounds(shard.index)
            if a < b:
                lo, hi = max(0, 2 * a - 2), min(sh.total, 2 * b)
                if x0 < x1:
                    lo, hi = min(lo, x0), max(hi, x1)
                x0, x1 = lo & ~1, hi
            cols.insert(0, (x0, x1))
        return cols

    def shard_pyramid(self, enc: torch.Tensor, shard: WidthShard) -> list:
        """The shard's columns of each pyramid level of an encoded clip
        (B, T, C, H, w), w the finest level's `pyramid_columns`: each level
        pooled from the one above's columns (AvgPool2d(3, 2, 1,
        count_include_pad=False) of a slice starting at an even column c
        gives columns c / 2 on, the first of them wrong unless c = 0), cut
        to the next level's columns and, for the output, to the shard's."""
        cols = self.pyramid_columns(shard)
        b, t = enc.shape[:2]
        cur, out = enc.reshape((b * t,) + enc.shape[2:]), []
        for level, (lo, hi) in enumerate(cols):
            if level:
                prev_lo = cols[level - 1][0]
                if lo < hi:
                    cur = avg_pool_3x3s2(cur)[..., lo - prev_lo // 2 : hi - prev_lo // 2]
                else:  # no columns from here on, at the level's height
                    cur = cur.new_zeros(cur.shape[:-2] + ((cur.shape[-2] + 1) // 2, 0))
            x0, x1 = shard.at(level).bounds(shard.index)
            y = cur[..., x0 - lo : x1 - lo] if x0 < x1 else cur[..., :0]
            out.append(y.reshape((b, t) + y.shape[1:]))
        return out

    def encode_shard(self, labels: torch.Tensor, inst: torch.Tensor | None,
                     shard: WidthShard, device, compute_dtype=None) -> list:
        """`encode_input` + the pyramid of the shard's columns of raw labels
        and instance maps (whole width, any device): the finest level's
        `pyramid_columns`, plus one a side (inside the image) for the
        instance edges, encoded on `device`, cast to `compute_dtype` and
        pooled (`shard_pyramid`)."""
        start, stop = self.pyramid_columns(shard)[0]
        lo, hi = max(0, start - 1), min(shard.total, stop + 1)
        with span(INPUT):
            enc = self.encode_input(labels[..., lo:hi].to(device),
                                    None if inst is None else inst[..., lo:hi].to(device))
            enc = enc[..., start - lo : stop - lo]
            if compute_dtype is not None:
                enc = enc.to(compute_dtype)
            return self.shard_pyramid(enc, shard)

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
        params: list[dict] | None = None, shard: WidthShard | None = None,
        local: bool = False,
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
        new state is detached: it crosses the chunk boundary. With `shard`
        this rank runs its columns of the whole encoded clip, and the
        outputs come whole (gathered: in training their gradient keeps this
        rank's columns). With `local` it returns (ClipOutputs, new state,
        the whole fakes detached), and on a shard the outputs stay at this
        rank's columns, as the training step's sharded losses take them
        (the whole fakes are the frames gathered for the ring buffers).
        """
        tG, n_scales = self.tG, self.n_scales
        n_frames = enc_a.shape[1] - (tG - 1)
        with span(INPUT):
            if shard is None:
                a_pyr = build_pyramid_video(enc_a, n_scales)
            else:
                start, stop = self.pyramid_columns(shard)[0]
                a_pyr = self.shard_pyramid(enc_a[..., start:stop], shard)
        bufs = tuple(stack_time(s) for s in state)
        ys = []
        for t in range(n_frames):
            wins = [p[:, t : t + tG] for p in a_pyr]
            detach = train and n_frames_bp > 0 and t % n_frames_bp == 0
            bufs, y = self._frame_pass(
                wins, bufs, use_raw_only, detach_prev=detach,
                detach_coarse=train and not finetune_all,
                remat=train and self.opt.remat, params=params, shard=shard,
            )
            ys.append(y)
        return self._clip_result(ys, bufs, shard, local)

    @torch.no_grad()
    def generate_clip_streaming(
        self, labels: torch.Tensor, inst: torch.Tensor | None, state: State, *,
        use_raw_only: bool = False, compute_dtype: torch.dtype | None = None,
        shard: WidthShard | None = None,
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
        is copied again. Inference only (no BPTT). With `shard` the rings
        hold this rank's columns (`encode_shard`).
        """
        tG, n_scales = self.tG, self.n_scales
        device = next(self.parameters()).device
        n_frames = labels.shape[1] - (tG - 1)

        def encode_frame(t: int) -> list[torch.Tensor]:
            if shard is not None:
                return self.encode_shard(
                    labels[:, t : t + 1], None if inst is None else inst[:, t : t + 1],
                    shard, device, compute_dtype)
            with span(INPUT):
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
            bufs, y = self._frame_pass(push(t + tG - 1), bufs, use_raw_only, shard=shard)
            ys.append(y)
        return self._clip_result(ys, bufs, shard)

    def _clip_result(self, ys: list, bufs: tuple, shard: WidthShard | None = None,
                     local: bool = False) -> tuple:
        """The frame passes' outputs stacked over time, and the new state
        (detached: it crosses the chunk boundary). On a shard the frames
        come whole and raw, flow and weight are gathered here, once a clip;
        with `local` all four stay at this rank's columns, and the whole
        frames, detached, come third."""
        fake, raw, flow, weight, whole = (
            None if ys[0][i] is None else torch.stack([y[i] for y in ys], 1)
            for i in range(5)
        )
        if shard is None:
            whole = fake
        elif not local:  # differentiable: the gradient keeps this rank's columns
            fake = whole
            raw, flow, weight = (None if t is None else halo.gather_width(t, shard)
                                 for t in (raw, flow, weight))
        new_state = tuple(unstack_time(b, self.tG - 1).detach() for b in bufs)
        outs = ClipOutputs(fake, raw, flow, weight)
        return (outs, new_state, whole.detach()) if local else (outs, new_state)

    def _apply_scale(self, s: int, params: dict | None, shard: WidthShard | None,
                     *args) -> CompositeOut:
        """Scale s on args, with `params` in place of its parameters if
        given, its layers reading `shard` (halo.sharded). The shard is set
        here, inside what remat checkpoints, so that the recompute in the
        backward (which may run on autograd's device thread) sees it too."""
        with halo.sharded(shard):
            if params is None:
                return self.scale(s)(*args)
            return torch.func.functional_call(self.scale(s), params, args)

    def _frame_pass(
        self, wins, bufs, use_raw_only, *, detach_prev=False,
        detach_coarse=False, remat=False, params=None, shard=None,
    ):
        """One frame through the coarse-to-fine scale stack.

        wins: per-level (B, tG, C, H, W) encoded windows, finest first;
        bufs: per-level channel-stacked (B, (tG-1)*3, H, W) ring buffers.
        Returns (new bufs, (fake, raw, flow, weight, the whole fake)). With
        `shard` the windows are this rank's columns and the buffers whole:
        each scale runs under halo.sharded, and its frame is gathered whole
        into the buffers (fake, raw, flow and weight are this rank's
        columns, the whole fake the gathered frame; None unsharded). The
        gathers are differentiable (halo.gather_width).
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
                # on a shard the recompute runs the whole scale: an early
                # stop at the last saved tensor could leave collectives out
                with (set_checkpoint_early_stop(False) if shard is not None
                      else contextlib.nullcontext()):
                    out = checkpoint(self._apply_scale, s, p, shard, *args,
                                     use_reentrant=False)
            else:
                out = self._apply_scale(s, p, shard, *args)
            if detach_coarse and s != n_scales - 1:
                out = CompositeOut(*(None if x is None else x.detach() for x in out))
            coarse = out
            frame = whole = out.img_final
            if shard is not None:  # the whole frame, for the ring and the caller
                whole = halo.gather_width(frame, shard)
            # ring buffer: drop the oldest frame, append this one (the
            # stored, gradient-connected frames)
            new_bufs[si] = torch.cat([bufs[si][:, c_out:], whole], 1)
        return tuple(new_bufs), (frame, coarse.img_raw, coarse.flow, coarse.weight,
                                 None if shard is None else whole)
