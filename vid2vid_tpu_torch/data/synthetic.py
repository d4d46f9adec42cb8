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


# ----------------------------------------------- face and pose frames
# Seeded stand-ins for the face and pose datasets' files (dlib landmarks,
# DensePose IUV renders, OpenPose JSON, frames), for tests and for runs on
# machines without the datasets or PIL. Shapes follow the files' layouts;
# the content is only plausible enough to exercise every drawing path.


def _ellipse(cx, cy, rx, ry, n, t0=0.0, t1=2 * np.pi):
    t = np.linspace(t0, t1, n)
    return np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)


def face_landmarks(rng: np.random.Generator, cx: float, cy: float, width: float,
                   mouth_open: float = 0.3) -> np.ndarray:
    """(68, 2) float dlib-layout landmarks of a face centred at (cx, cy)
    whose landmarks span `width` pixels in x (the jaw's ends, exact where
    cx +- width / 2 are binary fractions), so that data/face.py::
    face_crop_box's side is 2.5 * width (205 gives a 512 box). mouth_open 0
    puts every inner-lip point at the mouth's centre (a curve interp_curve
    rejects: an empty edge chain)."""
    s = width / 2
    u = np.zeros((68, 2))
    theta = np.linspace(0, np.pi, 17)
    u[:17] = np.stack([-np.cos(theta), 1.1 * np.sin(theta)], 1)           # jaw
    u[17:22] = np.stack([np.linspace(-0.8, -0.2, 5), -0.55 - 0.1 * np.sin(np.linspace(0, np.pi, 5))], 1)
    u[22:27] = u[17:22][::-1] * [-1, 1]                                    # brows
    u[27:31] = np.stack([np.zeros(4), np.linspace(-0.4, 0.05, 4)], 1)     # nose bridge
    u[31:36] = np.stack([np.linspace(-0.2, 0.2, 5), 0.15 + 0.05 * np.sin(np.linspace(0, np.pi, 5))], 1)
    u[36:42] = _ellipse(-0.4, -0.3, 0.15, 0.06, 7, np.pi, 3 * np.pi)[:6]  # eyes
    u[42:48] = _ellipse(0.4, -0.3, 0.15, 0.06, 7, np.pi, 3 * np.pi)[:6]
    u[48:60] = _ellipse(0.0, 0.5, 0.35, 0.15, 13, np.pi, 3 * np.pi)[:12]  # lips
    u[60:68] = _ellipse(0.0, 0.5, 0.25, 0.1 * mouth_open, 9, np.pi, 3 * np.pi)[:8]
    if mouth_open == 0:
        u[60:68] = [0.0, 0.5]
    pts = np.array([cx, cy]) + u * s
    pts[1:16] += rng.uniform(-1, 1, (15, 2))  # jitter, the jaw's ends kept
    pts[17:] += rng.uniform(-1, 1, (51, 2)) * (mouth_open != 0 or np.arange(17, 68)[:, None] < 60)
    return pts


def face_image(rng: np.random.Generator, h: int, w: int, landmarks: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 frame: a gradient with coloured boxes (edges for
    Canny outside the face) and a skin-coloured face over the landmarks."""
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([xx * 200 // w, yy * 200 // h, (xx + yy) * 100 // (h + w)], -1).astype(np.int32)
    for _ in range(6):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0 : y0 + rng.integers(8, h // 3), x0 : x0 + rng.integers(8, w // 3)] = rng.integers(0, 256, 3)
    (x0, y0), (x1, y1) = landmarks.min(0), landmarks.max(0)
    face = ((xx - (x0 + x1) / 2) / ((x1 - x0) / 2 + 1)) ** 2 + ((yy - (y0 + y1) / 2) / ((y1 - y0) / 2 + 1)) ** 2 < 1
    img[face] = [220, 170, 140]
    return np.clip(img + rng.integers(0, 8, img.shape), 0, 255).astype(np.uint8)


# BODY_25 joints of a standing figure, in units of its height, y down from
# the top of the head: nose, neck, right arm, left arm, mid hip, right leg,
# left leg, eyes, ears, left foot, right foot
_BODY_25 = np.array([
    [0.0, 0.07], [0.0, 0.16], [-0.09, 0.17], [-0.14, 0.30], [-0.16, 0.42],
    [0.09, 0.17], [0.14, 0.30], [0.16, 0.42], [0.0, 0.48], [-0.05, 0.48],
    [-0.06, 0.70], [-0.06, 0.92], [0.05, 0.48], [0.06, 0.70], [0.06, 0.92],
    [-0.02, 0.05], [0.02, 0.05], [-0.04, 0.06], [0.04, 0.06], [0.09, 0.96],
    [0.11, 0.95], [0.06, 0.94], [-0.09, 0.96], [-0.11, 0.95], [-0.06, 0.94],
])


def openpose_person(rng: np.random.Generator, cx: float, top: float, height: float,
                    conf: float = 0.9) -> dict:
    """One OpenPose person dict (BODY_25, 70 face and 2 x 21 hand points
    with confidences), as the JSON's "people" entries hold them."""
    body = np.array([cx, top]) + _BODY_25 * height + rng.uniform(-1, 1, (25, 2))
    face = np.zeros((70, 2))
    face[:68] = face_landmarks(rng, cx, top + 0.06 * height, 0.08 * height)
    face[68:] = face[[37, 43]]
    hands = [body[wrist] + _ellipse(0, 0.04 * height, 0.03 * height, 0.03 * height, 21, 0, np.pi)
             - [0, 0.04 * height] for wrist in (7, 4)]

    def flat(pts, c):
        c = np.broadcast_to(c, (len(pts),))
        return [float(v) for p, ci in zip(pts, c) for v in (p[0], p[1], ci)]

    confs = rng.uniform(0.5 * conf, conf, 25)
    confs[rng.integers(0, 25)] = 0.0  # one joint below the gate
    return {"pose_keypoints_2d": flat(body, confs), "face_keypoints_2d": flat(face, conf),
            "hand_left_keypoints_2d": flat(hands[0], conf),
            "hand_right_keypoints_2d": flat(hands[1], conf)}


def densepose_iuv(rng: np.random.Generator, h: int, w: int, cx: float, top: float,
                  height: float, face: bool = True) -> np.ndarray:
    """(h, w, 3) uint8 DensePose IUV render of a standing figure: U and V
    gradients, the part index (1..24) in channel 2; the head is parts 23 and
    24 (the face discriminator's key) unless `face` is False."""
    iuv = np.zeros((h, w, 3), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    boxes = [  # (part, x0, x1, y0, y1) in units of the height
        (1, -0.09, 0.0, 0.16, 0.48), (2, 0.0, 0.09, 0.16, 0.48),
        (3, -0.17, -0.09, 0.17, 0.42), (4, 0.09, 0.17, 0.17, 0.42),
        (7, -0.09, -0.01, 0.48, 0.70), (8, 0.01, 0.09, 0.48, 0.70),
        (11, -0.09, -0.01, 0.70, 0.96), (12, 0.01, 0.09, 0.70, 0.96),
        (23, -0.05, 0.0, 0.0, 0.15), (24, 0.0, 0.05, 0.0, 0.15),
    ]
    for part, x0, x1, y0, y1 in boxes:
        if part >= 23 and not face:
            continue
        m = ((xx >= cx + x0 * height) & (xx < cx + x1 * height)
             & (yy >= top + y0 * height) & (yy < top + y1 * height))
        iuv[m, 0] = (xx[m] * 7 + rng.integers(0, 40)) % 256
        iuv[m, 1] = (yy[m] * 5 + rng.integers(0, 40)) % 256
        iuv[m, 2] = part
    return iuv
