"""Middlebury .flo flow file IO (the port of
vid2vid_tpu/models/flownet2/flow_io.py; reference: flownet2_pytorch/utils/
flow_utils.py), in numpy.

Format: 4-byte magic 202021.25f, int32 width, int32 height, then
interleaved (u, v) float32, row-major.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as fh:
        magic = np.fromfile(fh, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(fh, np.int32, count=1)[0])
        h = int(np.fromfile(fh, np.int32, count=1)[0])
        data = np.fromfile(fh, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow to a .flo file."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as fh:
        np.float32(_MAGIC).tofile(fh)
        np.int32(w).tofile(fh)
        np.int32(h).tofile(fh)
        flow.tofile(fh)
