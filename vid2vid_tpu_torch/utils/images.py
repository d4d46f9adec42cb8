"""Array -> displayable image converters, the port of
vid2vid_tpu/utils/images.py (reference: util/util.py).

numpy on HWC arrays, as in the JAX package (callers move the port's
channel axis last):
  to_image: [-1, 1] float RGB -> uint8;
  label_to_color: integer / one-hot label map -> Cityscapes-style colours;
  flow_to_color: (H, W, 2) flow -> HSV direction / magnitude render.
"""

from __future__ import annotations

import numpy as np


def to_image(arr) -> np.ndarray:
    """[-1, 1] float (H, W, C) or (H, W) -> uint8 RGB."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    img = (arr + 1.0) / 2.0 * 255.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img


def _bitget(val, idx):
    return (val >> idx) & 1


def generic_colormap(n: int) -> np.ndarray:
    """The PASCAL-style bit-twiddled colormap (reference: util/util.py:175-195)."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= _bitget(c, 0) << (7 - j)
            g |= _bitget(c, 1) << (7 - j)
            b |= _bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


# Cityscapes 35-class palette (public dataset constants)
CITYSCAPES_35 = np.array([
    (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (111, 74, 0),
    (81, 0, 81), (128, 64, 128), (244, 35, 232), (250, 170, 160),
    (230, 150, 140), (70, 70, 70), (102, 102, 156), (190, 153, 153),
    (180, 165, 180), (150, 100, 100), (150, 120, 90), (153, 153, 153),
    (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35),
    (152, 251, 152), (70, 130, 180), (220, 20, 60), (255, 0, 0),
    (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
    (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
], np.uint8)


def label_to_color(labels, n_classes: int = 35) -> np.ndarray:
    """(H, W) int or (H, W, C) one-hot -> uint8 colour render."""
    labels = np.asarray(labels)
    if labels.ndim == 3:
        labels = labels.argmax(-1)
    labels = labels.astype(np.int64)
    if n_classes == 35:
        cmap = CITYSCAPES_35
    else:
        cmap = generic_colormap(max(n_classes, int(labels.max()) + 1))
    return cmap[np.clip(labels, 0, len(cmap) - 1)]


def flow_to_color(flow) -> np.ndarray:
    """(H, W, 2) flow -> HSV angle / magnitude uint8 RGB render."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u * u + v * v)
    ang = (np.arctan2(v, u) + np.pi) / (2 * np.pi)
    mag_n = mag / max(mag.max(), 1e-6)
    hsv = np.stack([ang, np.ones_like(ang), mag_n], -1)
    # vectorized hsv -> rgb
    i = (hsv[..., 0] * 6).astype(int) % 6
    f = hsv[..., 0] * 6 - np.floor(hsv[..., 0] * 6)
    p = hsv[..., 2] * (1 - hsv[..., 1])
    q = hsv[..., 2] * (1 - f * hsv[..., 1])
    t = hsv[..., 2] * (1 - (1 - f) * hsv[..., 1])
    vch = hsv[..., 2]
    r = np.choose(i, [vch, q, p, p, t, vch])
    g = np.choose(i, [t, vch, vch, q, p, p])
    b = np.choose(i, [p, p, t, vch, vch, q])
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)
