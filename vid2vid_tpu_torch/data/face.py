"""The face (edge map -> talking head) dataset, the port of
vid2vid_tpu/data/face.py (reference: data/face_dataset.py).

Each frame's conditioning is built from 68-point dlib landmarks
(`{phase}_keypoints/*.txt`, csv "x,y" per row) and the frame itself
(`{phase}_img/`):

  channel 0: the face edge raster (curves through landmark triplets) plus
             the frame's Canny edges outside the face region;
  channels 1..14: per-chain L1 distance maps (14 edge chains over the 8
             facial parts) -> 15 input channels;
  "inst":    the facial-part label polygon map (1..6), the feature
             encoder's pooling map.

Upper-skull points are mirrored from the jaw line (reference:
face_dataset.py:105-110); the whole clip is cropped to a square around the
face (2.5x the landmarks' width, the centre raised).

The rasters are data/raster.py's (cv2's fillPoly, distanceTransform and
Canny, PIL's grayscale, in numpy and scipy). `build_face_frame` builds one
frame from arrays, without a file (the card's machine has no PIL);
`read_face_frame` reads the two files and calls it. Like the JAX package,
the edge channel adds the Canny edges to the landmark edges in uint8, so a
pixel on both wraps to 254.

The dataset and the stream own their generators (a random.Random and an
np.random.RandomState seeded with opt.seed) and make the JAX package's
draws in its order. Dataset items are NCHW, as data/temporal.py's: "A"
(T, 15, H, W) float32, "B" (T, 3, H, W) float32 in [-1, 1], "inst" (T, H,
W) int32; the stream's are one frame, HWC, as the JAX stream's.
"""

from __future__ import annotations

import os
import random

import numpy as np

from vid2vid_tpu_torch.data import raster
from vid2vid_tpu_torch.data.files import check_path_valid, make_grouped_dataset
from vid2vid_tpu_torch.data.keypoints import draw_edge, interp_curve
from vid2vid_tpu_torch.data.temporal import _nchw
from vid2vid_tpu_torch.data.transforms import (
    get_img_params,
    get_video_params,
    image_size,
    transform_array,
)

# facial part polygons over the 83-point (68 + 15 mirrored) landmark set,
# and their labels (reference: face_dataset.py:93-102)
PART_POLYGONS = [
    [list(range(0, 17)) + list(range(68, 83)) + [0]],          # face outline
    [list(range(17, 22))],                                     # right eyebrow
    [list(range(22, 27))],                                     # left eyebrow
    [[28, 31], list(range(31, 36)), [35, 28]],                 # nose
    [[36, 37, 38, 39], [39, 40, 41, 36]],                      # right eye
    [[42, 43, 44, 45], [45, 46, 47, 42]],                      # left eye
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48]],       # mouth
    [list(range(60, 65)), [64, 65, 66, 67, 60]],               # tongue
]
PART_LABELS = [1, 2, 2, 3, 4, 4, 5, 6]

# test-time keypoint jitter ratios (reference: face_dataset.py:25-27)
_SCALE_RATIO = np.array([[0.9, 1], [1, 1], [0.9, 1], [1, 1.1], [0.9, 0.9], [0.9, 0.9]])
_SCALE_RATIO_SYM = np.array([[1, 1], [0.9, 1], [1, 1], [0.9, 1], [1, 1], [1, 1]])


def extend_keypoints(points: np.ndarray) -> np.ndarray:
    """Append 15 upper-skull points mirrored from the jaw line."""
    jaw = points[:17].astype(np.int32)
    baseline_y = (jaw[0, 1] + jaw[-1, 1]) / 2
    upper = jaw[1:-1].copy()
    upper[:, 1] = baseline_y + (baseline_y - upper[:, 1]) * 2 // 3
    return np.vstack([points, upper[::-1]])


def part_label_map(keypoints: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W) uint8 facial-part polygon labels."""
    w, h = size
    labels = np.zeros((h, w), np.uint8)
    for polys, label in zip(PART_POLYGONS, PART_LABELS):
        indices = [i for poly in polys for i in poly]
        raster.fill_poly(labels, keypoints[indices].astype(np.int32), label)
    return labels


def draw_part_edges(keypoints: np.ndarray, size: tuple[int, int]):
    """Returns (edge raster (H, W) uint8, list of per-chain edge rasters)."""
    w, h = size
    edge_len = 3
    all_edges = np.zeros((h, w), np.uint8)
    chains = []
    for polys in PART_POLYGONS:
        for poly in polys:
            chain = np.zeros((h, w), np.uint8)
            for i in range(0, max(1, len(poly) - 1), edge_len - 1):
                seg = poly[i : i + edge_len]
                cx, cy = interp_curve(keypoints[seg, 0], keypoints[seg, 1])
                draw_edge(all_edges, cx, cy)
                draw_edge(chain, cx, cy)
            chains.append(chain)
    return all_edges, chains


def distance_maps(chains: list[np.ndarray]) -> list[np.ndarray]:
    """Per-chain clipped L1 distance transforms (uint8); an empty chain
    gives 255 everywhere."""
    return [np.clip(raster.distance_l1(c) / 3, 0, 255).astype(np.uint8) for c in chains]


def face_crop_box(keypoints: np.ndarray, size: tuple[int, int]):
    """Square crop around the face: 2.5x the landmarks' width, the centre
    raised (reference: face_dataset.py:159-169). (y0, y1, x0, x1)."""
    min_y, max_y = keypoints[:, 1].min(), keypoints[:, 1].max()
    min_x, max_x = keypoints[:, 0].min(), keypoints[:, 0].max()
    xc = (min_x + max_x) // 2
    yc = (min_y * 3 + max_y) // 4
    side = (max_x - min_x) * 2.5
    xc = min(max(0, xc - side // 2) + side, size[0]) - side // 2
    yc = min(max(0, yc - side // 2) + side, size[1]) - side // 2
    return (
        int(yc - side // 2), int(yc + side // 2),
        int(xc - side // 2), int(xc + side // 2),
    )


def jitter_keypoints(keypoints: np.ndarray) -> None:
    """random_scale_points test-time augmentation (in place)."""

    def scale(part, idx, sym):
        flat = [i for poly in part for i in poly]
        ratios = _SCALE_RATIO_SYM if sym else _SCALE_RATIO
        rx, ry = ratios[idx]
        mean = keypoints[flat].mean(axis=0)
        if sym:
            for poly in part:
                pts = keypoints[poly]
                m = pts.mean(axis=0)
                new_m = (m - mean) * [rx, ry] + mean
                keypoints[poly] = pts - m + new_m
        else:
            pts = keypoints[flat]
            keypoints[flat] = (pts - mean) * [rx, ry] + mean

    scale(PART_POLYGONS[1] + PART_POLYGONS[2], 1, sym=True)
    scale(PART_POLYGONS[4] + PART_POLYGONS[5], 3, sym=True)
    for i, part in enumerate(PART_POLYGONS):
        scale(part, PART_LABELS[i] - 1, sym=False)


def build_face_frame(points: np.ndarray, rgb: np.ndarray, opt, params, crop_box):
    """One frame from its 68 landmarks (float, (68, 2)) and its (H, W, 3)
    uint8 image: (A (h, w, 15) float32 in [0, 1], B (h, w, 3) float32 in
    [-1, 1], part labels (h, w) int32), cropped to `crop_box` and
    transformed by `params`. The edge and distance channels resample
    bilinear, the labels nearest, the image bicubic."""
    size = rgb.shape[1], rgb.shape[0]
    points = extend_keypoints(points)
    if not opt.isTrain and opt.random_scale_points:
        jitter_keypoints(points)
    part_labels = part_label_map(points, size)
    edges, chains = draw_part_edges(points, size)
    if not opt.no_canny_edge:
        canny = raster.canny(raster.rgb_to_gray(rgb), 100, 200) > 0
        edges = edges + (canny * (part_labels == 0) * 255).astype(np.uint8)
    y0, y1, x0, x1 = crop_box

    def chan(arr, method="bilinear"):
        return transform_array(arr[y0:y1, x0:x1], opt, params, method)

    channels = [np.asarray(chan(edges), np.float32) / 255.0]
    if not opt.no_dist_map:
        channels += [np.asarray(chan(d), np.float32) / 255.0 for d in distance_maps(chains)]
    a = np.stack(channels, axis=-1)
    label = np.asarray(chan(part_labels, "nearest"), np.int32)
    b = np.asarray(chan(rgb, "bicubic"), np.float32) / 255.0 * 2.0 - 1.0
    return a, b, label


def load_keypoints(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",")


def read_face_frame(kp_path: str, img_path: str, opt, params, crop_box):
    """build_face_frame on a landmark file and an image file."""
    from PIL import Image

    rgb = np.asarray(Image.open(img_path).convert("RGB"))
    return build_face_frame(load_keypoints(kp_path), rgb, opt, params, crop_box)


def clip_params(opt, kp_path: str, img_path: str, rng, np_rng):
    """(crop box, transform params) of a clip from its first frame."""
    crop_box = face_crop_box(load_keypoints(kp_path), image_size(img_path))
    y0, y1, x0, x1 = crop_box
    return crop_box, get_img_params(opt, (x1 - x0, y1 - y0), rng, np_rng)


class FaceDataset:
    def __init__(self, opt):
        self.opt = opt
        phase = opt.phase if opt.isTrain else "test"
        self.a_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_keypoints"))
        self.b_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_img"))
        check_path_valid(self.a_paths, self.b_paths)
        self.n_of_seqs = len(self.a_paths)
        self.seq_len_max = max(len(a) for a in self.a_paths)
        self.n_frames_total = opt.n_frames_total
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)

    def __len__(self):
        return self.n_of_seqs

    def set_n_frames_total(self, n: int):
        cap = min(128, self.seq_len_max) - (self.opt.n_frames_G - 1)
        self.n_frames_total = min(n, max(cap, 1))

    def __getitem__(self, index: int):
        opt = self.opt
        seq = index % self.n_of_seqs
        kp_paths, img_paths = self.a_paths[seq], self.b_paths[seq]
        n_total, start, t_step = get_video_params(
            opt, self.n_frames_total, len(kp_paths), index, self.np_rng)
        crop_box, params = clip_params(opt, kp_paths[start], img_paths[start],
                                       self.rng, self.np_rng)
        frames = [read_face_frame(kp_paths[start + i * t_step], img_paths[start + i * t_step],
                                  opt, params, crop_box) for i in range(n_total)]
        a, b, label = zip(*frames)
        return {"A": _nchw(list(a)), "B": _nchw(list(b)), "inst": np.stack(label),
                "A_path": kp_paths[start], "seq": seq}


class FaceTestStream:
    """The face test set one frame at a time, with per-sequence crop state
    and change_seq flags (reference: face_dataset.py:29-64); --start_frame
    offsets the first sequence only."""

    __test__ = False  # not a pytest class

    def __init__(self, opt):
        self.ds = FaceDataset(opt.replace(isTrain=False) if opt.isTrain else opt)
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)

    def __iter__(self):
        opt = self.ds.opt
        for seq in range(self.ds.n_of_seqs):
            kp_paths, img_paths = self.ds.a_paths[seq], self.ds.b_paths[seq]
            crop_box, params = clip_params(opt, kp_paths[0], img_paths[0],
                                           self.rng, self.np_rng)
            start = min(opt.start_frame, len(kp_paths) - 1) if seq == 0 else 0
            for idx in range(start, len(kp_paths)):
                a, b, label = read_face_frame(kp_paths[idx], img_paths[idx], opt, params,
                                              crop_box)
                yield {"A": a, "B": b, "inst": label, "change_seq": idx == start,
                       "path": kp_paths[idx], "seq": seq}
