"""Standalone flow-net harness (the port of
vid2vid_tpu/models/flownet2/harness.py; reference: models/flownet2_pytorch/
main.py), inference side: validation EPE and an inference loop that writes
.flo files. Training (train_epoch, fit) and checkpoints are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from vid2vid_tpu_torch.models.flownet2.flow_io import write_flo
from vid2vid_tpu_torch.models.flownet2.losses import epe
from vid2vid_tpu_torch.ops.resize import resize_bilinear
from vid2vid_tpu_torch.utils.device import require_device

TRAINING_NOT_PORTED = (
    "flow-net training and checkpoints are not ported yet (ROADMAP.md, "
    "queue 1: the flow-net training harness)"
)


class FlowHarness:
    """Validate one flow network (FlowNetC / S / SD) and write its flows.

    `net` holds its weights; the harness runs it in eval mode on `device`,
    the first CUDA device unless the caller passes device='cpu'.
    Datasets yield numpy (pair (2, H, W, 3), flow (H, W, 2)) samples.
    """

    def __init__(
        self, net: nn.Module, div_flow: float = 0.05,
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.net = net.to(self.device).eval()
        self.div_flow = div_flow

    def _predict(self, pair: np.ndarray) -> torch.Tensor:
        """(1, 2, H, W) flow at the pair's resolution, in pixels: flows[0]
        upsampled bilinearly and divided by div_flow."""
        p = torch.from_numpy(np.ascontiguousarray(pair)).permute(0, 3, 1, 2)
        x = torch.cat([p[0], p[1]], 0)[None].to(self.device, torch.float32)
        with torch.no_grad():
            flows = self.net(x)
        finest = flows[0] if isinstance(flows, (tuple, list)) else flows
        h, w = pair.shape[1:3]
        return resize_bilinear(finest, h, w) / self.div_flow

    def validate(self, dataset) -> float:
        """Mean EPE over the dataset."""
        errs = []
        for i in range(len(dataset)):
            pair, flow = dataset[i]
            target = torch.from_numpy(np.ascontiguousarray(flow)).permute(2, 0, 1)[None]
            errs.append(float(epe(self._predict(pair), target.to(self.device))))
        return float(np.mean(errs))

    def infer_to_flo(self, dataset, out_dir: str) -> None:
        """Write one <index:06d>.flo per sample to out_dir."""
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(dataset)):
            pair, _ = dataset[i]
            pred = self._predict(pair)[0].permute(1, 2, 0).cpu().numpy()
            write_flo(os.path.join(out_dir, f"{i:06d}.flo"), pred)

    def train_epoch(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def fit(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def restore_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)
