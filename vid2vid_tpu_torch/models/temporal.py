"""Temporal-pyramid frame bookkeeping for the temporal discriminators.

The port of vid2vid_tpu/models/temporal.py: pure functions on (B, T, C, H,
W) clips (the time axis is 1, as in the JAX package's (B, T, H, W, C)),
re-deriving the reference's stateful buffers (reference:
models/vid2vid_model_D.py:275-328). Buffer lengths and chunk offsets are
Python ints.

Dense (`skipped_frames`): one growing buffer per stream; every chunk,
extract all stride-tD^s groups of tD frames that end inside the new chunk,
then trim the buffer to tD^(t_scales-1)*(tD-1) trailing frames.

Sparse (`skipped_frames_sparse`, --sparse_D): per-scale buffers that keep
only the stride-subsampled stream.

None of them reads across columns: on training's model axis the trainer
gives them its rank's columns of the frames, flows and confidence
(train/loop.py), and the groups they return feed the temporal
discriminators at those columns.
"""

from __future__ import annotations

import torch


def skipped_frames(
    b_all: torch.Tensor | None, b_new: torch.Tensor, t_scales: int, td: int
):
    """Dense group extraction.

    b_all: (B, L, C, H, W) past frames, or None at the clip's start;
    b_new: (B, T, C, H, W) this chunk's frames. Returns (new b_all,
    skipped): skipped[s] is (B*G_s, td, C, H, W) or None — G_s groups of td
    frames with stride td^s, each ending in this chunk. The past frames
    enter detached.
    """
    b_all = b_new if b_all is None else torch.cat([b_all.detach(), b_new], 1)
    length, n_new = b_all.shape[1], b_new.shape[1]
    skipped: list[torch.Tensor | None] = []
    for s in range(t_scales):
        tds = td**s
        span = tds * (td - 1)
        n_groups = min(length - span, n_new)
        groups = [
            b_all[:, length - span - t - 1 : length - t : tds]
            for t in range(0, max(n_groups, 0), td)
        ]
        skipped.append(torch.cat(groups, 0) if groups else None)
    max_prev = td ** (t_scales - 1) * (td - 1)
    if length > max_prev:
        b_all = b_all[:, -max_prev:]
    return b_all, skipped


def skipped_flows(
    flow_all: torch.Tensor | None, conf_all: torch.Tensor | None,
    flow_new: torch.Tensor, conf_new: torch.Tensor, t_scales: int, td: int,
):
    """Scale-0 reference flows for the temporal groups: the adjacent-frame
    flows without each group's first entry. The coarser scales' flows are
    recomputed between the skipped real frames by the trainer (reference:
    models/vid2vid_model_D.py:292-302)."""
    flow_all, fgroups = skipped_frames(flow_all, flow_new, 1, td)
    conf_all, cgroups = skipped_frames(conf_all, conf_new, 1, td)
    flow_skipped: list[torch.Tensor | None] = [None] * t_scales
    conf_skipped: list[torch.Tensor | None] = [None] * t_scales
    if fgroups[0] is not None:
        flow_skipped[0] = fgroups[0][:, 1:]
        conf_skipped[0] = cgroups[0][:, 1:]
    return flow_all, conf_all, flow_skipped, conf_skipped


def skipped_frames_sparse(
    b_all: list, b_new: torch.Tensor, t_scales: int, td: int,
    n_frames_load: int, chunk_start: int, is_flow: bool = False,
):
    """Sparse (--sparse_D) variant: per-scale subsampled buffers.

    `chunk_start` is the first frame index of this chunk within the clip
    (the reference's loop variable i).
    """
    b_all = list(b_all)
    skipped: list[torch.Tensor | None] = [None] * t_scales
    for s in range(t_scales):
        t_len = b_all[s].shape[1] if b_all[s] is not None else 0
        if t_len > 0 and t_len % td == 0:
            b_all[s] = b_all[s][:, -(td - 1):]
        if s == 0:
            tmp = b_new
        else:
            tds = td**s
            idx_start = 0 if chunk_start == 0 else tds - ((chunk_start - 1) % tds + 1)
            tmp = b_new[:, idx_start::tds] if idx_start < n_frames_load else None
        if tmp is not None:
            b_all[s] = tmp if b_all[s] is None else torch.cat([b_all[s].detach(), tmp], 1)
        t_len = b_all[s].shape[1] if b_all[s] is not None else 0
        if t_len >= td:
            b_all[s] = b_all[s][:, t_len % td:]
            b, length = b_all[s].shape[:2]
            g = b_all[s].reshape((b * (length // td), td) + b_all[s].shape[2:])
            skipped[s] = g[:, 1:] if is_flow else g
    return b_all, skipped
