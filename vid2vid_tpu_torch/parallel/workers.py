"""Running one training chunk by chunk on the ranks of a mesh, so that its
ranks can be held to one another and to one process.

  - `run_chunks`: every chunk of one global clip through
    Trainer.train_chunk (which keeps this rank's rows), with the per-chunk
    losses and a digest of the weights after each chunk (equal digests:
    equal weights, bit for bit);
  - `deterministic_algorithms`: cuDNN's and PyTorch's deterministic
    algorithms for a block (two runs of one training on a card differ
    without them).
"""

from __future__ import annotations

import contextlib
import time

import torch

from vid2vid_tpu_torch.parallel.mesh import weights_digest
from vid2vid_tpu_torch.train.loop import Trainer


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic convolutions and PyTorch's deterministic
    algorithms for the block (a warning, not an error, for an op that has
    none), so that two runs of one training on a card can be compared bit
    for bit."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def run_chunks(trainer: Trainer, state, labels, frames, inst, n_load: int,
               after_chunk=None) -> dict:
    """Every chunk of n_load frames of one global clip through
    `trainer.train_chunk` (which keeps this rank's rows): {"losses": per
    chunk, "digests": of the weights after each chunk, "ms": host ms a
    chunk (the losses' readback ends each)}. `after_chunk(k, trainer,
    carry)`, if given, runs after chunk k and its digest; the carry it
    returns, if any, takes the place of the clip's."""
    tg = trainer.opt.n_frames_G
    t_len = n_load + tg - 1
    carry = trainer.start_clip()
    out = {"losses": [], "digests": [], "ms": []}
    for i in range(0, labels.shape[1] - t_len + 1, n_load):
        t0 = time.perf_counter()
        state, carry, losses = trainer.train_chunk(
            state, carry, labels[:, i : i + t_len], frames[:, i : i + t_len],
            None if inst is None else inst[:, i : i + t_len])
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(losses)
        out["digests"].append(weights_digest(trainer.gen, trainer.engine))
        if after_chunk is not None:
            carry = after_chunk(len(out["ms"]) - 1, trainer, carry) or carry
    return out
