"""Host-side image transforms, the port of vid2vid_tpu/data/transforms.py
(reference: data/base_dataset.py:82-212).

Per clip, one set of random spatial parameters (resize target, crop
position, horizontal flip) is drawn and applied to every frame. Sizes are
rounded to /4, then to the nearest multiple of 32 (`make_power_2`).

The JAX package draws from the global `random` and `np.random`; the port
draws from a `random.Random` and an `np.random.RandomState` that the caller
owns, with the same method calls in the same order, so the same seed gives
the same draws. PIL is imported only by the functions that read a file or
resize to a new size: `transform_array` transforms arrays whose resize keeps
their size without it.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np


def make_power_2(n: int, base: int = 32) -> int:
    return int(round(n / base) * base)


@dataclasses.dataclass
class ImgParams:
    new_size: tuple[int, int]  # (w, h)
    crop_size: tuple[int, int]
    crop_pos: tuple[int, int]
    flip: bool


def get_img_params(
    opt, size: tuple[int, int], rng: random.Random, np_rng: np.random.RandomState,
) -> ImgParams:
    """Resize target, crop and flip of one clip whose frames are `size`
    (w, h): x of the crop gaussian around the centre (sigma span / 3,
    clamped), y uniform in [0, min(slack, H / 8)]."""
    w, h = size
    new_h, new_w = h, w
    roc = opt.resize_or_crop
    if "resize" in roc:
        new_h = new_w = opt.loadSize
    elif "scaleWidth" in roc:
        new_w = opt.loadSize
        new_h = opt.loadSize * h // w
    elif "scaleHeight" in roc:
        new_h = opt.loadSize
        new_w = opt.loadSize * w // h
    elif "randomScaleWidth" in roc:
        new_w = rng.randint(opt.fineSize, opt.loadSize + 1)
        new_h = new_w * h // w
    elif "randomScaleHeight" in roc:
        new_h = rng.randint(opt.fineSize, opt.loadSize + 1)
        new_w = new_h * w // h
    new_w = int(round(new_w / 4)) * 4
    new_h = int(round(new_h / 4)) * 4

    crop_x = crop_y = crop_w = crop_h = 0
    if "crop" in roc or "scaledCrop" in roc:
        if "crop" in roc:
            crop_w = crop_h = opt.fineSize
        elif "Width" in roc:
            crop_w = opt.fineSize
            crop_h = opt.fineSize * h // w
        else:
            crop_h = opt.fineSize
            crop_w = opt.fineSize * w // h
        crop_w, crop_h = make_power_2(crop_w), make_power_2(crop_h)
        x_span = (new_w - crop_w) // 2
        crop_x = int(np.clip(int(np_rng.randn() * x_span / 3 + x_span), 0, x_span * 2))
        crop_y = rng.randint(0, int(min(max(0, new_h - crop_h), new_h // 8)))
    else:
        new_w, new_h = make_power_2(new_w), make_power_2(new_h)

    flip = (rng.random() > 0.5) and (opt.dataset_mode != "pose") and (
        opt.isTrain and not opt.no_flip
    )
    return ImgParams((new_w, new_h), (crop_w, crop_h), (crop_x, crop_y), flip)


# PIL's resampling filters by name (Image.NEAREST, BILINEAR, BICUBIC)
RESAMPLE = {"nearest": 0, "bilinear": 2, "bicubic": 3}


def target_size(opt, params: ImgParams) -> tuple[int, int]:
    """(w, h) every frame is resized to before the crop."""
    if "resize" in opt.resize_or_crop:
        return opt.loadSize, opt.loadSize
    return params.new_size


def _crops(opt) -> bool:
    return "crop" in opt.resize_or_crop or "scaledCrop" in opt.resize_or_crop


def apply_transform(img, opt, params: ImgParams, method: str = "bicubic"):
    """Scale -> crop -> flip a PIL image by the clip's parameters, resampled
    by `method`: "nearest" (label maps), "bilinear" (the face channels) or
    "bicubic" (images)."""
    from PIL import Image

    img = img.resize(target_size(opt, params), RESAMPLE[method])
    if _crops(opt):
        ow, oh = img.size
        tw, th = params.crop_size
        x1, y1 = params.crop_pos
        if ow > tw or oh > th:
            img = img.crop((x1, y1, min(ow, x1 + tw), min(oh, y1 + th)))
    if params.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def transform_array(arr: np.ndarray, opt, params: ImgParams, method: str) -> np.ndarray:
    """apply_transform on an (H, W) or (H, W, C) uint8 array, returning an
    array. Where the resize keeps the size it is the identity (Pillow
    returns a copy), and the crop and flip are numpy slices: no PIL. A
    resize to a new size goes through PIL."""
    h, w = arr.shape[:2]
    if target_size(opt, params) != (w, h):
        from PIL import Image

        return np.asarray(apply_transform(Image.fromarray(arr), opt, params, method))
    if _crops(opt):
        tw, th = params.crop_size
        x1, y1 = params.crop_pos
        if w > tw or h > th:
            arr = arr[y1 : min(h, y1 + th), x1 : min(w, x1 + tw)]
    if params.flip:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def image_size(path: str) -> tuple[int, int]:
    """(w, h) of an image file."""
    from PIL import Image

    with Image.open(path) as probe:
        return probe.size


def load_image_rgb(path: str, opt, params: ImgParams) -> np.ndarray:
    """Image -> (H, W, 3) float32 in [-1, 1]."""
    from PIL import Image

    img = apply_transform(Image.open(path).convert("RGB"), opt, params)
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


def load_label_map(path: str, opt, params: ImgParams) -> np.ndarray:
    """Label map -> (H, W) int32 class ids (nearest resampling)."""
    from PIL import Image

    arr = np.asarray(apply_transform(Image.open(path), opt, params, "nearest"))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)


def get_video_params(
    opt, n_frames_total: int, cur_seq_len: int, index: int,
    np_rng: np.random.RandomState,
) -> tuple[int, int, int]:
    """(n_frames_total, start_idx, t_step) of one training clip (reference:
    data/base_dataset.py:177-202): a random temporal stride up to
    max_t_step, a random start, the total rounded to whole chunks."""
    tG = opt.n_frames_G
    if not opt.isTrain:
        return tG, index, 1
    n_frames_total = min(n_frames_total, cur_seq_len - tG + 1)
    n_per_load = opt.max_frames_per_gpu * max(opt.n_devices, 1)
    n_per_load = min(n_frames_total, n_per_load)
    n_loadings = n_frames_total // n_per_load
    n_frames_total = n_per_load * n_loadings + tG - 1

    max_t_step = max(1, min(opt.max_t_step, (cur_seq_len - 1) // max(1, n_frames_total - 1)))
    t_step = np_rng.randint(max_t_step) + 1
    offset_max = max(1, cur_seq_len - (n_frames_total - 1) * t_step)
    if opt.dataset_mode == "pose":
        start_idx = index % offset_max
    else:
        start_idx = np_rng.randint(offset_max)
    return n_frames_total, start_idx, t_step
