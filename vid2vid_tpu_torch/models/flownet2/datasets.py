"""Flow datasets (the port of vid2vid_tpu/models/flownet2/datasets.py;
reference: models/flownet2_pytorch/datasets.py), in numpy.

Folder-format readers for the standard flow benchmarks, yielding
(image_pair (2, H, W, 3) float32, flow (H, W, 2) float32) numpy samples
(the JAX package's layout; the harness moves them to NCHW) with a center
crop to a multiple of 64. PIL is imported where an image is read, so the
module imports without it:

  MpiSintelClean / MpiSintelFinal  — <root>/<pass>/<scene>/frame_NNNN.png
                                     + <root>/flow/<scene>/frame_NNNN.flo
  FlyingChairs                     — <root>/NNNNN_img{1,2}.ppm + _flow.flo
  ImagesFromFolder                 — consecutive frame pairs, no flow
"""

from __future__ import annotations

import glob
import os

import numpy as np

from vid2vid_tpu_torch.models.flownet2.flow_io import read_flo


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _center_crop64(*arrays: np.ndarray) -> list[np.ndarray]:
    h, w = arrays[0].shape[:2]
    ch, cw = h // 64 * 64, w // 64 * 64
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return [a[y0 : y0 + ch, x0 : x0 + cw] for a in arrays]


class MpiSintel:
    def __init__(self, root: str, dstype: str = "clean"):
        flow_root = os.path.join(root, "flow")
        image_root = os.path.join(root, dstype)
        self.samples = []
        for flo in sorted(
            glob.glob(os.path.join(flow_root, "*", "frame_*.flo"))
        ):
            scene = os.path.basename(os.path.dirname(flo))
            idx = int(os.path.basename(flo)[6:10])
            img1 = os.path.join(image_root, scene, f"frame_{idx:04d}.png")
            img2 = os.path.join(image_root, scene, f"frame_{idx + 1:04d}.png")
            if os.path.exists(img1) and os.path.exists(img2):
                self.samples.append((img1, img2, flo))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img1, img2, flo = self.samples[i]
        a, b, f = _center_crop64(
            _load_image(img1), _load_image(img2), read_flo(flo)
        )
        return np.stack([a, b]), f


class MpiSintelClean(MpiSintel):
    def __init__(self, root: str):
        super().__init__(root, "clean")


class MpiSintelFinal(MpiSintel):
    def __init__(self, root: str):
        super().__init__(root, "final")


class FlyingChairs:
    def __init__(self, root: str):
        flows = sorted(glob.glob(os.path.join(root, "*_flow.flo")))
        self.samples = [
            (f.replace("_flow.flo", "_img1.ppm"),
             f.replace("_flow.flo", "_img2.ppm"), f)
            for f in flows
        ]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img1, img2, flo = self.samples[i]
        a, b, f = _center_crop64(
            _load_image(img1), _load_image(img2), read_flo(flo)
        )
        return np.stack([a, b]), f


class ImagesFromFolder:
    """Consecutive frame pairs from a directory; zero flow targets."""

    def __init__(self, root: str, ext: str = "png"):
        frames = sorted(glob.glob(os.path.join(root, f"*.{ext}")))
        self.samples = list(zip(frames[:-1], frames[1:]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img1, img2 = self.samples[i]
        a, b = _center_crop64(_load_image(img1), _load_image(img2))
        return np.stack([a, b]), np.zeros(a.shape[:2] + (2,), np.float32)


class FlyingThings:
    """FlyingThings3D into-future pairs (reference: flownet2_pytorch/
    datasets.py:200-252): <root>/<dstype>/TRAIN/*/*/{left,right}/*.png
    paired with <root>/optical_flow_flo_format/TRAIN/*/*/into_future/
    {left,right}/*.flo; flow i maps frame i -> i+1."""

    def __init__(self, root: str, dstype: str = "frames_cleanpass"):
        image_dirs = sorted(glob.glob(os.path.join(root, dstype, "TRAIN", "*", "*")))
        image_dirs = sorted(
            [os.path.join(d, "left") for d in image_dirs]
            + [os.path.join(d, "right") for d in image_dirs]
        )
        flow_dirs = sorted(
            glob.glob(
                os.path.join(root, "optical_flow_flo_format", "TRAIN", "*", "*")
            )
        )
        flow_dirs = sorted(
            [os.path.join(d, "into_future", "left") for d in flow_dirs]
            + [os.path.join(d, "into_future", "right") for d in flow_dirs]
        )
        self.samples = []
        for idir, fdir in zip(image_dirs, flow_dirs):
            images = sorted(glob.glob(os.path.join(idir, "*.png")))
            flows = sorted(glob.glob(os.path.join(fdir, "*.flo")))
            for i in range(len(flows)):
                if i + 1 < len(images):
                    self.samples.append((images[i], images[i + 1], flows[i]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img1, img2, flo = self.samples[i]
        a, b, f = _center_crop64(
            _load_image(img1), _load_image(img2), read_flo(flo)
        )
        return np.stack([a, b]), f


class FlyingThingsClean(FlyingThings):
    def __init__(self, root: str):
        super().__init__(root, "frames_cleanpass")


class FlyingThingsFinal(FlyingThings):
    def __init__(self, root: str):
        super().__init__(root, "frames_finalpass")


class ChairsSDHom:
    """ChairsSDHom small-displacement set (reference: flownet2_pytorch/
    datasets.py:242-311): <root>/<dstype>/{t0,t1,flow}/*.png|*.flo with the
    flow stored vertically flipped (the reference's `flow[::-1]`)."""

    def __init__(self, root: str, dstype: str = "train"):
        image1 = sorted(glob.glob(os.path.join(root, dstype, "t0", "*.png")))
        image2 = sorted(glob.glob(os.path.join(root, dstype, "t1", "*.png")))
        flows = sorted(glob.glob(os.path.join(root, dstype, "flow", "*.flo")))
        self.samples = list(zip(image1, image2, flows))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img1, img2, flo = self.samples[i]
        flow = read_flo(flo)[::-1]
        a, b, f = _center_crop64(_load_image(img1), _load_image(img2), flow)
        return np.stack([a, b]), np.ascontiguousarray(f)
