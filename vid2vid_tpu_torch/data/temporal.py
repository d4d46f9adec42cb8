"""The paired temporal video dataset, the port of vid2vid_tpu/data/temporal.py
(reference: data/temporal_dataset.py).

Reads the grouped directories `{phase}_A`, `{phase}_B` (and `{phase}_inst`
under --use_instance). An item is one clip of `n_frames_total` frames
(rounded to whole chunks, plus the tG - 1 warm-up frames), with one random
crop / flip and a random temporal stride, drawn from the dataset's own
`rng` (random.Random) and `np_rng` (np.random.RandomState), both seeded
with opt.seed; seeding the JAX package's global generators with the same
seed gives the same draws.

Item arrays, in the port's NCHW layout (the loader adds the batch axis):
  A: (T, H, W) int32 labels when label_nc > 0, else (T, C, H, W) float32
  B: (T, 3, H, W) float32 in [-1, 1]
  inst: (T, H, W) int32, or None
plus "A_path" (the clip's first label file) and "seq" (its sequence).
"""

from __future__ import annotations

import os
import random

import numpy as np

from vid2vid_tpu_torch.data.files import check_path_valid, make_grouped_dataset
from vid2vid_tpu_torch.data.transforms import (
    get_img_params,
    get_video_params,
    image_size,
    load_image_rgb,
    load_label_map,
)


def _nchw(frames: list[np.ndarray]) -> np.ndarray:
    """(H, W, C) frames -> one (T, C, H, W) array."""
    return np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))


class TemporalDataset:
    def __init__(self, opt):
        self.opt = opt
        phase = opt.phase if opt.isTrain else "test"
        self.dir_a = os.path.join(opt.dataroot, f"{phase}_A")
        self.dir_b = os.path.join(opt.dataroot, f"{phase}_B")
        self.a_is_label = opt.label_nc != 0

        self.a_paths = make_grouped_dataset(self.dir_a)
        self.b_paths = make_grouped_dataset(self.dir_b)
        check_path_valid(self.a_paths, self.b_paths)
        if opt.use_instance:
            self.i_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_inst"))
            check_path_valid(self.a_paths, self.i_paths)

        self.n_of_seqs = len(self.a_paths)
        self.seq_len_max = max(len(a) for a in self.a_paths)
        self.n_frames_total = opt.n_frames_total
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)

    def __len__(self):
        return self.n_of_seqs

    def set_n_frames_total(self, n: int):
        """The curriculum hook (reference: base_dataset.py:19-24)."""
        cap = min(128, self.seq_len_max) - (self.opt.n_frames_G - 1)
        self.n_frames_total = min(n, max(cap, 1))

    def __getitem__(self, index: int):
        opt = self.opt
        seq = index % self.n_of_seqs
        a_paths = self.a_paths[seq]
        b_paths = self.b_paths[seq]

        n_total, start, t_step = get_video_params(
            opt, self.n_frames_total, len(a_paths), index, self.np_rng)
        params = get_img_params(opt, image_size(b_paths[start]), self.rng, self.np_rng)

        a_frames, b_frames, i_frames = [], [], []
        for i in range(n_total):
            idx = start + i * t_step
            if self.a_is_label:
                a_frames.append(load_label_map(a_paths[idx], opt, params))
            else:
                a_frames.append(load_image_rgb(a_paths[idx], opt, params))
            b_frames.append(load_image_rgb(b_paths[idx], opt, params))
            if opt.use_instance:
                i_frames.append(load_label_map(self.i_paths[seq][idx], opt, params))

        return {
            "A": np.stack(a_frames) if self.a_is_label else _nchw(a_frames),
            "B": _nchw(b_frames),
            "inst": np.stack(i_frames) if i_frames else None,
            "A_path": a_paths[start],
            "seq": seq,
        }
