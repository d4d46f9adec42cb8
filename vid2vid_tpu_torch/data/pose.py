"""The pose (DensePose + OpenPose -> dancing body) dataset, the port of
vid2vid_tpu/data/pose.py (reference: data/pose_dataset.py).

Conditioning per frame: the DensePose IUV render (3 channels, the part
index channel renormalized from /255 to /24 units) and the rasterized
OpenPose skeleton (3 channels), 6 channels; frames and conditioning are
cropped to the central half width, rounded to /32. Training augmentation:
random per-part DensePose dropout and optional face-label removal.

`pose_conditioning` builds a frame's channels from the IUV array and the
parsed OpenPose people, without a file (the card's machine has no PIL);
the dataset reads `{phase}_densepose/`, `{phase}_openpose/` and
`{phase}_img/` and calls it. The dataset owns three generators seeded with
opt.seed: a random.Random (`rng`: the crop and flip draws, the loader's
shuffle), an np.random.RandomState (`np_rng`: the stride and the crop's x)
and the JAX package's np.random.default_rng (`gen`: the sequence choice,
the dropout and the OpenPose jitter), each drawn in the JAX package's order.
Dataset items are NCHW: "A" (T, 6, H, W) float32, "B" (T, 3, H, W), "inst"
None; the stream's are one frame, HWC, as the JAX stream's.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from vid2vid_tpu_torch.data.files import check_path_valid, make_grouped_dataset
from vid2vid_tpu_torch.data.keypoints import render_openpose_people
from vid2vid_tpu_torch.data.temporal import _nchw
from vid2vid_tpu_torch.data.transforms import (
    get_img_params,
    get_video_params,
    image_size,
    transform_array,
)

DENSEPOSE_FACE_PARTS = (23, 24)


def central_crop(arr: np.ndarray, base: int = 32) -> np.ndarray:
    """Crop the central half width, rounded to a multiple of `base`."""
    w = arr.shape[1]
    x_cen = w // 2
    bs = int(w * 0.25) // base * base
    return arr[:, x_cen - bs : x_cen + bs]


def densepose_dropout(
    arr: np.ndarray, drop_prob: float, remove_face: bool, rng: np.random.Generator,
) -> np.ndarray:
    """Randomly zero whole body parts in an IUV render (H, W, 3)."""
    parts = arr[:, :, 2]
    out = arr.copy()
    for part_id in range(1, 25):
        if rng.random() < drop_prob:
            out[parts == part_id] = 0
    if remove_face:
        out[np.isin(parts, DENSEPOSE_FACE_PARTS)] = 0
    return out


class PoseNormalizer:
    """Test-time pose retargeting (reference: pose_dataset.py:100-132); no
    caller, as in the JAX package.

    On the first frame, measures the torso span from the DensePose V channel
    (parts 1|2), derives a scale ratio and offsets against a target centre
    and height, then applies the same pad + crop + resize to every frame so
    the driving pose matches the training subject's framing.
    """

    def __init__(self, target_yc: float, target_len: float):
        self.target_yc = target_yc
        self.target_len = target_len
        self._params = None

    def fit(self, iuv: np.ndarray) -> None:
        """iuv: (H, W, 3) uint8 DensePose render of the first frame."""
        h, w = iuv.shape[:2]
        parts = iuv[:, :, 2]
        ys, xs = np.nonzero((parts == 1) | (parts == 2))
        if len(ys) == 0:
            self._params = (0, 0, 1.0, 0)
            return
        y_min, y_max = ys.min(), ys.max()
        i_min, i_max = np.argmin(ys), np.argmax(ys)
        v_min = iuv[ys[i_min], xs[i_min], 1] / 255.0
        v_max = iuv[ys[i_max], xs[i_max], 1] / 255.0
        denom = max(v_max - v_min, 1e-3)
        ylen = (y_max - y_min) / denom
        yc = (0.5 - v_min) / denom * (y_max - y_min) + y_min

        ratio = self.target_len / max(ylen, 1e-3)
        offset_y = int(yc - self.target_yc / ratio)
        offset_x = int(w * (1 - 1 / ratio) / 2)
        padding = int(max(0, max(-offset_y, int(offset_y + h / ratio) - h)))
        padding = int(max(padding, max(-offset_x, int(offset_x + w / ratio) - w)))
        self._params = (offset_y + padding, offset_x + padding, ratio, padding)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Apply the fitted pad + crop + resize to an (H, W, C) frame."""
        from PIL import Image

        if self._params is None:
            raise RuntimeError("call fit() on the first frame")
        oy, ox, ratio, p = self._params
        h, w = img.shape[:2]
        padded = np.pad(img, ((p, p), (p, p), (0, 0)))
        crop = padded[oy : int(oy + h / ratio), ox : int(ox + w / ratio)]
        return np.asarray(Image.fromarray(crop).resize((w, h)))


def pose_conditioning(iuv, people, size: tuple[int, int], opt, params,
                      gen: np.random.Generator) -> np.ndarray:
    """One frame's (h, w, 6) float32 conditioning in [-1, 1] (3 under
    --openpose_only or --densepose_only), before the central crop: `iuv`
    the (H, W, 3) uint8 DensePose render, `people` the OpenPose JSON's
    "people", `size` the frame's (w, h). Training drops DensePose parts
    and OpenPose limbs with `gen`."""
    chans = []
    if not opt.openpose_only:
        dp = iuv
        if opt.isTrain:
            dp = densepose_dropout(dp, opt.random_drop_prob, opt.remove_face_labels, gen)
        dp_arr = np.asarray(transform_array(dp, opt, params, "nearest"),
                            np.float32) / 255.0 * 2.0 - 1.0
        # the part channel in /24 units (reference: pose_dataset.py:44)
        dp_arr[..., 2] = ((dp_arr[..., 2] * 0.5 + 0.5) * 255 / 24 - 0.5) / 0.5
        chans.append(dp_arr)
    if not opt.densepose_only:
        drop = opt.random_drop_prob if opt.isTrain else 0.0
        op = render_openpose_people(people, size, drop, opt.remove_face_labels,
                                    opt.basic_point_only, gen)
        chans.append(np.asarray(transform_array(op, opt, params, "nearest"),
                                np.float32) / 255.0 * 2.0 - 1.0)
    return np.concatenate(chans, axis=-1)


def pose_image(rgb: np.ndarray, opt, params) -> np.ndarray:
    """A frame's (H, W, 3) uint8 image -> (h, w, 3) float32 in [-1, 1]."""
    return np.asarray(transform_array(rgb, opt, params, "bicubic"), np.float32) / 255.0 * 2.0 - 1.0


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class PoseDataset:
    def __init__(self, opt):
        self.opt = opt
        phase = opt.phase if opt.isTrain else "test"
        self.img_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_img"))
        if not opt.openpose_only:
            self.dp_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_densepose"))
            check_path_valid(self.dp_paths, self.img_paths)
        if not opt.densepose_only:
            self.op_paths = make_grouped_dataset(os.path.join(opt.dataroot, f"{phase}_openpose"))
            check_path_valid(self.op_paths, self.img_paths)

        self.n_of_seqs = len(self.img_paths)
        self.seq_len_max = max(len(p) for p in self.img_paths)
        self.frames_count = [len(p) - opt.n_frames_G + 1 for p in self.img_paths]
        # length-weighted sequence sampling (reference: base_dataset.py:42-44)
        total = sum(self.frames_count)
        self.folder_prob = [c / total for c in self.frames_count]
        self.n_frames_total = opt.n_frames_total
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)
        self.gen = np.random.default_rng(opt.seed)

    def __len__(self):
        return sum(self.frames_count) if not self.opt.isTrain else self.n_of_seqs

    def set_n_frames_total(self, n: int):
        cap = min(128, self.seq_len_max) - (self.opt.n_frames_G - 1)
        self.n_frames_total = min(n, max(cap, 1))

    def conditioning(self, seq: int, idx: int, size, params) -> np.ndarray:
        """pose_conditioning on the frame's files."""
        opt = self.opt
        iuv = None if opt.openpose_only else _read_rgb(self.dp_paths[seq][idx])
        people = None
        if not opt.densepose_only:
            with open(self.op_paths[seq][idx], encoding="utf-8") as fh:
                people = json.load(fh)["people"]
        return pose_conditioning(iuv, people, size, opt, params, self.gen)

    def __getitem__(self, index: int):
        opt = self.opt
        if opt.isTrain:
            seq = int(self.gen.choice(self.n_of_seqs, p=self.folder_prob))
        else:
            seq = index % self.n_of_seqs
        img_paths = self.img_paths[seq]
        n_total, start, t_step = get_video_params(
            opt, self.n_frames_total, len(img_paths), index, self.np_rng)
        size = image_size(img_paths[start])
        params = get_img_params(opt, size, self.rng, self.np_rng)
        a_frames, b_frames = [], []
        for i in range(n_total):
            idx = start + i * t_step
            a_frames.append(central_crop(self.conditioning(seq, idx, size, params)))
            b_frames.append(central_crop(pose_image(_read_rgb(img_paths[idx]), opt, params)))
        return {"A": _nchw(a_frames), "B": _nchw(b_frames), "inst": None,
                "A_path": img_paths[start], "seq": seq}


class PoseTestStream:
    """The pose test set one frame at a time (per-frame, change_seq);
    --start_frame offsets the first sequence only."""

    __test__ = False  # not a pytest class

    def __init__(self, opt):
        self.opt = opt if not opt.isTrain else opt.replace(isTrain=False)
        self.ds = PoseDataset(self.opt)

    def __iter__(self):
        opt = self.opt
        for seq in range(self.ds.n_of_seqs):
            img_paths = self.ds.img_paths[seq]
            size = image_size(img_paths[0])
            params = get_img_params(opt, size, self.ds.rng, self.ds.np_rng)
            start = min(opt.start_frame, len(img_paths) - 1) if seq == 0 else 0
            for idx in range(start, len(img_paths)):
                a = self.ds.conditioning(seq, idx, size, params)
                b = pose_image(_read_rgb(img_paths[idx]), opt, params)
                yield {"A": central_crop(a), "B": central_crop(b), "inst": None,
                       "change_seq": idx == start, "path": img_paths[idx], "seq": seq}
