"""Keypoint -> raster conditioning, the port of vid2vid_tpu/data/keypoints.py
(reference: data/keypoint2img.py).

Host-side numpy rasterization of OpenPose body/hand/face keypoints into
the RGB skeleton images the pose model conditions on, plus the shared
curve-drawing primitives the face dataset uses. `render_openpose_people`
draws parsed people dicts (no file: the card's machine builds its items in
memory); `render_openpose` reads the JSON and calls it.

Behavioral spec preserved from the reference:
  - curves through keypoint triplets are least-squares quadratics (linear
    for 2 points), sampled at 1px steps along the dominant axis; quadratics
    with |a| > 1 are rejected (reference: keypoint2img.py:45-67);
  - edges are drawn with square brushes of half-width bw, blending 50/50
    with any color already present (reference: keypoint2img.py:15-43);
  - the OpenPose edge lists / per-limb colors are the standard BODY_25 +
    hand + face connectivity constants;
  - confidence gating: face/hand edges need every endpoint above threshold
    (0.1 face, 0.01 others); body keypoints are zeroed individually;
  - training-time augmentation: random limb dropout with probability
    `random_drop_prob`, jitter on head/face points when removing face labels.
"""

from __future__ import annotations

import json

import numpy as np

# OpenPose BODY_25 skeleton connectivity + per-limb colors (public-standard
# constants, identical to the reference's lists).
HEAD_EDGES = [[17, 15], [15, 0], [0, 16], [16, 18]]
HEAD_COLORS = [[153, 0, 153], [153, 0, 102], [102, 0, 153], [51, 0, 153]]
BODY_EDGES = [
    [0, 1], [1, 8],
    [1, 2], [2, 3], [3, 4],
    [1, 5], [5, 6], [6, 7],
    [8, 9], [9, 10], [10, 11], [11, 24], [11, 22], [22, 23],
    [8, 12], [12, 13], [13, 14], [14, 21], [14, 19], [19, 20],
]
BODY_COLORS = [
    [153, 0, 51], [153, 0, 0],
    [153, 51, 0], [153, 102, 0], [153, 153, 0],
    [102, 153, 0], [51, 153, 0], [0, 153, 0],
    [0, 153, 51], [0, 153, 102], [0, 153, 153], [0, 153, 153],
    [0, 153, 153], [0, 153, 153],
    [0, 102, 153], [0, 51, 153], [0, 0, 153], [0, 0, 153],
    [0, 0, 153], [0, 0, 153],
]
HAND_EDGES = [
    [0, 1, 2, 3, 4],
    [0, 5, 6, 7, 8],
    [0, 9, 10, 11, 12],
    [0, 13, 14, 15, 16],
    [0, 17, 18, 19, 20],
]
HAND_COLORS = [[204, 0, 0], [163, 204, 0], [0, 204, 82], [0, 82, 204], [163, 0, 204]]
FACE_EDGE_GROUPS = [
    [list(range(17, 22))],
    [list(range(22, 27))],
    [list(range(27, 31)), list(range(31, 36))],
    [[36, 37, 38, 39], [39, 40, 41, 36]],
    [[42, 43, 44, 45], [45, 46, 47, 42]],
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],
]


def interp_curve(x: np.ndarray, y: np.ndarray):
    """Least-squares quadratic (or linear) curve through the points,
    sampled at unit steps along the dominant axis. Returns (None, None)
    for degenerate/too-curved fits."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if np.abs(np.diff(x)).max(initial=0) < np.abs(np.diff(y)).max(initial=0):
        cy, cx = interp_curve(y, x)
        return (None, None) if cy is None else (cx, cy)
    deg = 1 if len(x) < 3 else 2
    try:
        coeffs = np.polyfit(x, y, deg)
    except (np.linalg.LinAlgError, ValueError):
        return None, None
    if deg == 2 and abs(coeffs[0]) > 1:
        return None, None
    if x[0] > x[-1]:
        x = x[::-1]
    n = int(x[-1] - x[0])
    if n <= 0:
        return None, None
    curve_x = np.linspace(x[0], x[-1], n)
    curve_y = np.polyval(coeffs, curve_x)
    return curve_x.astype(int), curve_y.astype(int)


def _blend(im: np.ndarray, yy, xx, color):
    if im.ndim == 3:
        blank = (im[yy, xx] == 0).all(axis=-1)
        mixed = ((im[yy, xx].astype(float) + color) / 2).astype(np.uint8)
        im[yy, xx] = np.where(blank[..., None], np.asarray(color, np.uint8), mixed)
    else:
        im[yy, xx] = color[0]


def draw_edge(
    im: np.ndarray,
    x: np.ndarray | None,
    y: np.ndarray | None,
    bw: int = 1,
    color=(255, 255, 255),
    draw_end_points: bool = False,
):
    """Draw a polyline with a square brush; optionally disc end caps."""
    if x is None or not np.size(x):
        return
    h, w = im.shape[:2]
    for i in range(-bw, bw):
        for j in range(-bw, bw):
            yy = np.clip(y + i, 0, h - 1)
            xx = np.clip(x + j, 0, w - 1)
            _blend(im, yy, xx, color)
    if draw_end_points:
        ends_y = np.array([y[0], y[-1]])
        ends_x = np.array([x[0], x[-1]])
        for i in range(-bw * 2, bw * 2):
            for j in range(-bw * 2, bw * 2):
                if i * i + j * j < 4 * bw * bw:
                    yy = np.clip(ends_y + i, 0, h - 1)
                    xx = np.clip(ends_x + j, 0, w - 1)
                    _blend(im, yy, xx, color)


def _gate_keypoints(pts: np.ndarray) -> np.ndarray:
    """Zero out low-confidence keypoints per the reference's rules."""
    p = pts.shape[0]
    thresh = 0.1 if p == 70 else 0.01
    out = np.zeros((p, 2))
    if p == 70:  # face: gate whole edges
        for group in FACE_EDGE_GROUPS:
            for edge in group:
                if (pts[edge, 2] > thresh).all():
                    out[edge] = pts[edge, :2]
    elif p == 21:  # hand: gate whole fingers
        for edge in HAND_EDGES:
            if (pts[edge, 2] > thresh).all():
                out[edge] = pts[edge, :2]
    else:  # body: gate individual joints
        valid = pts[:, 2] > thresh
        out[valid] = pts[valid, :2]
    return out


def render_openpose(
    json_path: str,
    size: tuple[int, int],
    random_drop_prob: float = 0.0,
    remove_face_labels: bool = False,
    basic_point_only: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """OpenPose JSON -> (H, W, 3) uint8 skeleton raster."""
    with open(json_path, encoding="utf-8") as fh:
        people = json.load(fh)["people"]
    return render_openpose_people(
        people, size, random_drop_prob, remove_face_labels, basic_point_only, rng)


def render_openpose_people(
    people: list[dict],
    size: tuple[int, int],
    random_drop_prob: float = 0.0,
    remove_face_labels: bool = False,
    basic_point_only: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """OpenPose people (the JSON's "people" list) -> (H, W, 3) uint8
    skeleton raster of size (w, h); the limb dropout and the face jitter
    draw from `rng`."""
    rng = rng or np.random.default_rng()
    w, h = size
    out = np.zeros((h, w, 3), np.uint8)

    pose_edges = ([] if basic_point_only else HEAD_EDGES) + BODY_EDGES
    pose_colors = ([] if basic_point_only else HEAD_COLORS) + BODY_COLORS

    for person in people:
        pose = np.array(person["pose_keypoints_2d"]).reshape(25, 3)
        face = np.array(person["face_keypoints_2d"]).reshape(70, 3)
        hand_l = np.array(person["hand_left_keypoints_2d"]).reshape(21, 3)
        hand_r = np.array(person["hand_right_keypoints_2d"]).reshape(21, 3)
        pose, face, hand_l, hand_r = (
            _gate_keypoints(p) for p in (pose, face, hand_l, hand_r)
        )

        canvas = np.zeros((h, w, 3), np.uint8)
        if random_drop_prob > 0 and remove_face_labels:
            pose[[0, 15, 16, 17, 18]] += 5 * rng.standard_normal((5, 2))
            face[:, 0] += 2 * rng.standard_normal()
            face[:, 1] += 2 * rng.standard_normal()

        for edge, color in zip(pose_edges, pose_colors):
            x, y = pose[edge, 0], pose[edge, 1]
            if rng.random() > random_drop_prob and 0 not in x:
                cx, cy = interp_curve(x, y)
                draw_edge(canvas, cx, cy, bw=3, color=color, draw_end_points=True)

        if not basic_point_only:
            for hand in (hand_l, hand_r):
                if rng.random() > random_drop_prob:
                    for edge, color in zip(HAND_EDGES, HAND_COLORS):
                        for j in range(len(edge) - 1):
                            x = hand[edge[j : j + 2], 0]
                            y = hand[edge[j : j + 2], 1]
                            if 0 not in x:
                                cx, cy = interp_curve(x, y)
                                draw_edge(
                                    canvas, cx, cy, bw=1, color=color,
                                    draw_end_points=True,
                                )
            if rng.random() > random_drop_prob:
                for group in FACE_EDGE_GROUPS:
                    for edge in group:
                        for i in range(0, max(1, len(edge) - 1)):
                            x = face[edge[i : i + 2], 0]
                            y = face[edge[i : i + 2], 1]
                            if 0 not in x:
                                cx, cy = interp_curve(x, y)
                                draw_edge(canvas, cx, cy, draw_end_points=True)
        out += canvas
    return out
