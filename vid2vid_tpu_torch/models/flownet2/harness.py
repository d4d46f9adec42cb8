"""Standalone flow-net harness (the port of
vid2vid_tpu/models/flownet2/harness.py; reference: models/flownet2_pytorch/
main.py): train one flow network with the multiscale pyramid loss and Adam,
validate it by EPE, keep best-EPE checkpoints and write .flo files.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch
from torch import nn

from vid2vid_tpu_torch.models.flownet2.flow_io import write_flo
from vid2vid_tpu_torch.models.flownet2.losses import epe, multiscale_flow_loss
from vid2vid_tpu_torch.ops.resize import resize_bilinear
from vid2vid_tpu_torch.utils.device import require_device, to_cpu
from vid2vid_tpu_torch.utils.precision import cudnn_f32


def _nchw_pair(pair, device) -> torch.Tensor:
    """(B, 2, H, W, 3) frame pairs -> (B, 6, H, W) f32, the two frames
    stacked on channels (first frame first)."""
    p = torch.as_tensor(np.ascontiguousarray(pair) if isinstance(pair, np.ndarray) else pair)
    b, _, h, w, _ = p.shape
    return p.to(device, torch.float32).permute(0, 1, 4, 2, 3).reshape(b, 6, h, w)


def _nchw_flow(flow, device) -> torch.Tensor:
    """(B, H, W, 2) flows -> (B, 2, H, W) f32."""
    f = torch.as_tensor(np.ascontiguousarray(flow) if isinstance(flow, np.ndarray) else flow)
    return f.to(device, torch.float32).permute(0, 3, 1, 2)


class FlowHarness:
    """Train and validate one flow network (FlowNetC / S / SD; training
    wants `train_outputs=True`, the five pyramid flows) and write its flows.

    The harness holds the weights (`net`, moved to `device`: the first CUDA
    device unless the caller passes device='cpu') and their Adam state, and
    updates both in place. Adam has optax's defaults (beta 0.9 / 0.999, eps
    1e-8 outside the square root), as the JAX package's `optax.adam(lr)`.
    f32 steps and validation run with cuDNN's TF32 off. `mixed_precision`
    mirrors the JAX package's (the analog of the reference's fp16 path,
    flownet2_pytorch/main.py:278-289): each step runs the forward on a bf16
    copy of the f32 master weights and a bf16 input, casts the flows to f32
    for the loss, and the gradient lands on the masters through the cast;
    bf16's range needs no loss scaling. Datasets yield numpy (pair (2, H, W,
    3), flow (H, W, 2)) samples.
    """

    def __init__(
        self, net: nn.Module, lr: float = 1e-4, div_flow: float = 0.05,
        mixed_precision: bool = False, device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.net = net.to(self.device).eval()
        self.div_flow = div_flow
        self.compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.optimizer = torch.optim.Adam(
            self.net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    # ------------------------------------------------------------- training

    def train_step(self, pair, flow) -> tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on (B, 2, H, W, 3) pairs and (B, H, W, 2) flows;
        returns (loss, EPE at the finest level) as device scalars. The
        parameters' gradients stay in `.grad` until the next step."""
        x = _nchw_pair(pair, self.device)
        target = _nchw_flow(flow, self.device)
        with cudnn_f32():
            if self.compute_dtype == torch.float32:
                flows = self.net(x)
            else:
                params = {n: p.to(self.compute_dtype) for n, p in self.net.named_parameters()}
                flows = torch.func.functional_call(self.net, params, (x.to(self.compute_dtype),))
            loss, err = multiscale_flow_loss([f.float() for f in flows], target, self.div_flow)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        return loss.detach(), err.detach()

    def train_epoch(self, dataset, log_every: int = 50) -> float:
        """One pass over the dataset, one sample a step; the mean EPE. The
        EPEs stay on the device but every `log_every` steps, when the mean of
        the last `log_every` is printed."""
        errs = []
        for i in range(len(dataset)):
            pair, flow = dataset[i]
            _, err = self.train_step(pair[None], flow[None])
            errs.append(err)
            if (i + 1) % log_every == 0:
                recent = torch.stack(errs[-log_every:]).cpu().numpy()
                print(f"  [{i + 1}/{len(dataset)}] EPE {np.mean(recent):.3f}")
        return float(np.mean(torch.stack(errs).cpu().numpy()))

    def fit(
        self, train_ds, val_ds, n_epochs: int, save_dir: str | None = None,
        prefix: str = "flownet", log_every: int = 50,
    ) -> float:
        """Epoch loop with a validation each epoch and best-EPE tracking
        (reference: flownet2_pytorch/main.py:406-423); saves a checkpoint
        each epoch when `save_dir` is given. Returns the best validation
        EPE."""
        best_epe = float("inf")
        for epoch in range(1, n_epochs + 1):
            t0 = time.time()
            train_epe = self.train_epoch(train_ds, log_every=log_every)
            val_epe = self.validate(val_ds)
            is_best = val_epe < best_epe
            best_epe = min(best_epe, val_epe)
            print(
                f"epoch {epoch}/{n_epochs}: train EPE {train_epe:.3f}, "
                f"val EPE {val_epe:.3f}{' (best)' if is_best else ''} "
                f"[{time.time() - t0:.0f}s]"
            )
            if save_dir is not None:
                self.save_checkpoint(epoch, best_epe, save_dir, prefix, is_best=is_best)
        return best_epe

    # ----------------------------------------------------------- checkpoints

    @staticmethod
    def checkpoint_file(save_dir: str, prefix: str, best: bool = False) -> str:
        tag = "model_best" if best else "checkpoint"
        return os.path.join(save_dir, f"{prefix}_{tag}.pth.tar")

    def save_checkpoint(
        self, epoch: int, best_epe: float, save_dir: str, prefix: str = "flownet",
        is_best: bool = False,
    ) -> None:
        """<save_dir>/<prefix>_checkpoint.pth.tar in the reference's layout
        (flownet2_pytorch/utils/tools.py:137-142: `arch`, `epoch`,
        `state_dict` under the reference's names, `best_EPE`) plus the Adam
        state (`optimizer`), copied to <prefix>_model_best.pth.tar on a new
        best. Tensors go to the CPU; each file is written beside its name and
        renamed over it."""
        os.makedirs(save_dir, exist_ok=True)
        payload = {
            "arch": type(self.net).__name__,
            "epoch": epoch,
            "state_dict": to_cpu(self.net.state_dict()),
            "best_EPE": float(best_epe),
            "optimizer": to_cpu(self.optimizer.state_dict()),
        }
        path = self.checkpoint_file(save_dir, prefix)
        torch.save(payload, path + ".part")
        os.replace(path + ".part", path)
        if is_best:
            best = self.checkpoint_file(save_dir, prefix, best=True)
            shutil.copyfile(path, best + ".part")
            os.replace(best + ".part", best)

    def restore_checkpoint(
        self, save_dir: str, prefix: str = "flownet", best: bool = False
    ) -> tuple[int, float]:
        """Load the latest (or best) checkpoint's weights and Adam state in
        place; returns (epoch, best EPE)."""
        payload = torch.load(self.checkpoint_file(save_dir, prefix, best),
                             map_location="cpu", weights_only=True)
        self.net.load_state_dict(payload["state_dict"])
        self.optimizer.load_state_dict(payload["optimizer"])
        return int(payload["epoch"]), float(payload["best_EPE"])

    # ------------------------------------------------------------ inference

    def _predict(self, pair: np.ndarray) -> torch.Tensor:
        """(1, 2, H, W) flow at the pair's resolution, in pixels: flows[0]
        upsampled bilinearly and divided by div_flow (f32 weights)."""
        x = _nchw_pair(pair[None], self.device)
        with torch.no_grad(), cudnn_f32():
            flows = self.net(x)
        finest = flows[0] if isinstance(flows, (tuple, list)) else flows
        h, w = pair.shape[1:3]
        return resize_bilinear(finest, h, w) / self.div_flow

    def validate(self, dataset) -> float:
        """Mean EPE over the dataset."""
        errs = []
        for i in range(len(dataset)):
            pair, flow = dataset[i]
            errs.append(float(epe(self._predict(pair), _nchw_flow(flow[None], self.device))))
        return float(np.mean(errs))

    def infer_to_flo(self, dataset, out_dir: str) -> None:
        """Write one <index:06d>.flo per sample to out_dir."""
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(dataset)):
            pair, _ = dataset[i]
            pred = self._predict(pair)[0].permute(1, 2, 0).cpu().numpy()
            write_flo(os.path.join(out_dir, f"{i:06d}.flo"), pred)

