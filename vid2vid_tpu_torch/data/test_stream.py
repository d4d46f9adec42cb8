"""The test-time frame stream of the temporal datasets (label2city).

The port of vid2vid_tpu/data/temporal.py::TestTemporalStream:
`{dataroot}/test_A/<sequence>/<frame>` label maps (or RGB conditioning
when label_nc == 0), with `test_inst/` instance maps under --use_instance
and `test_B/` real frames under --use_real_img. Each item is a dict with
"A" (H, W) int32 labels or (H, W, 3) float32, "B" and "inst" (or None),
"change_seq", "path" and "seq". The scan and the transforms are
data/files.py's and data/transforms.py's; images are read with PIL,
imported when a frame is read. The face and pose streams are
data/face.py's and data/pose.py's.
"""

from __future__ import annotations

import os
import random

import numpy as np

from vid2vid_tpu_torch.data.files import make_grouped_dataset
from vid2vid_tpu_torch.data.transforms import (
    get_img_params,
    image_size,
    load_image_rgb,
    load_label_map,
)


class TestTemporalStream:
    """One frame at a time, sequence after sequence, with sequence-change
    flags; --start_frame offsets the first sequence only."""

    __test__ = False  # not a pytest class

    def __init__(self, opt):
        self.opt = opt
        self.a_paths = make_grouped_dataset(os.path.join(opt.dataroot, "test_A"))
        self.b_paths = (
            make_grouped_dataset(os.path.join(opt.dataroot, "test_B"))
            if opt.use_real_img else None
        )
        self.i_paths = (
            make_grouped_dataset(os.path.join(opt.dataroot, "test_inst"))
            if opt.use_instance else None
        )
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)

    def __iter__(self):
        opt = self.opt
        for seq_idx, seq in enumerate(self.a_paths):
            params = get_img_params(opt, image_size(seq[0]), self.rng, self.np_rng)
            start = min(opt.start_frame, len(seq) - 1) if seq_idx == 0 else 0
            for k in range(start, len(seq)):
                yield {
                    "A": (load_label_map if opt.label_nc != 0 else load_image_rgb)(
                        seq[k], opt, params
                    ),
                    "B": None if self.b_paths is None
                    else load_image_rgb(self.b_paths[seq_idx][k], opt, params),
                    "inst": None if self.i_paths is None
                    else load_label_map(self.i_paths[seq_idx][k], opt, params),
                    "change_seq": k == start,
                    "path": seq[k],
                    "seq": seq_idx,
                }
