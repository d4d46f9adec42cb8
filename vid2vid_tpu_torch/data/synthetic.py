"""A synthetic moving-square clip for training smoke runs.

The port of vid2vid_tpu/data/synthetic.py::moving_square_clip (the clip the
JAX package's training benchmark trains on): a coloured square moving over
a static background, the label map marking the square (class 1) against
the background (class 0). The same generator draws give the same clip as
the JAX package's; the images come out NCHW.
"""

from __future__ import annotations

import numpy as np


def moving_square_clip(
    rng: np.random.Generator, n_frames: int, height: int, width: int,
    n_classes: int = 2,
):
    """Returns (labels (1, T, H, W) int32, images (1, T, 3, H, W) float32
    in [-1, 1])."""
    size = max(4, height // 4)
    x = rng.integers(0, width - size)
    y = rng.integers(0, height - size)
    vx, vy = rng.integers(1, 4), rng.integers(1, 4)
    color = rng.uniform(0.2, 1.0, size=3).astype(np.float32)

    labels = np.zeros((1, n_frames, height, width), np.int32)
    imgs = np.full((1, n_frames, 3, height, width), -1.0, np.float32)
    for t in range(n_frames):
        labels[0, t, y : y + size, x : x + size] = min(1, n_classes - 1)
        imgs[0, t, :, y : y + size, x : x + size] = color[:, None, None]
        x = int(np.clip(x + vx, 0, width - size))
        y = int(np.clip(y + vy, 0, height - size))
        if x in (0, width - size):
            vx = -vx
        if y in (0, height - size):
            vy = -vy
    return labels, imgs
