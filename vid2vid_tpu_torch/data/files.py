"""Grouped video-directory scanning, the port of vid2vid_tpu/data/files.py
(reference: data/image_folder.py).

A dataset root holds one subdirectory per video sequence; each holds that
sequence's per-frame files in sorted order. Keypoint text / json files
count as frames (face and pose conditioning).
"""

from __future__ import annotations

import os

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".webp",
    ".txt", ".json",
)


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def make_grouped_dataset(root: str) -> list[list[str]]:
    """[[seq0_frame0, seq0_frame1, ...], [seq1_frame0, ...], ...], sequences
    and frames sorted."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{root} is not a directory")
    sequences = []
    for dirname in sorted(os.listdir(root)):
        subdir = os.path.join(root, dirname)
        if not os.path.isdir(subdir):
            continue
        frames = sorted(
            os.path.join(dp, f)
            for dp, _, files in os.walk(subdir)
            for f in files
            if is_image_file(f)
        )
        if frames:
            sequences.append(frames)
    return sequences


def check_path_valid(a_paths: list[list[str]], b_paths: list[list[str]]) -> None:
    """Raise unless two roots hold the same number of sequences, each with
    the same number of frames."""
    if len(a_paths) != len(b_paths):
        raise ValueError(f"sequence count mismatch: {len(a_paths)} vs {len(b_paths)}")
    for a, b in zip(a_paths, b_paths):
        if len(a) != len(b):
            raise ValueError(
                f"frame count mismatch: {a[0]} has {len(a)} vs {b[0]} has {len(b)}")
