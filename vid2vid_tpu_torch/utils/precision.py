"""The port's f32 precision rule for cuDNN.

PyTorch's default lets cuDNN run float32 convolutions in TF32 (about three
decimal digits). The modules that the port keeps in float32 — FlowNet2
(`FlowEstimator`), the discriminators, VGG19, the single-image first-frame
nets and their Encoder (`InferenceEngine.single_g_first_frames`,
`face_features`), and the training steps, whose backward runs the same
convolutions' gradients — turn it off for their own
calls with `cudnn_f32`, whatever the caller's setting, and give the
caller's setting back afterwards. bfloat16 convolutions are unaffected.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cudnn_f32():
    """cuDNN convolutions in full f32 (no TF32) for the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
