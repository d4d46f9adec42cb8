"""chip_smoke.py's phase 12 (the data axis, `ddp_train_path`) with a planted
fault: the two ranks' batch norms left unsynced, and the losses' bounds
switched off, so that the phase stops at its chunk-1 weight-displacement
check and prints where that check lands against DDP_DISPLACEMENT_REL_L2.

Run on a machine with one H100, from the root of a checkout:

    python3 chip_ddp_fault.py

It builds the kernels first (as chip_smoke.py does). The phase's ranks
import this script anew (the spawn start method), so the fault applies in
them too. Expected: an AssertionError naming the displacement.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vid2vid_tpu_torch.nn.layers import sync_batch_norm  # noqa: E402

_trainer = cs.ddp_trainer


def ddp_trainer(n_devices: int, batch: int, device):
    """The phase's Trainer; on a data axis, its norms left unsynced."""
    trainer, state = _trainer(n_devices, batch, device)
    if n_devices > 1:
        sync_batch_norm(trainer.gen, None)
        sync_batch_norm(trainer.engine, None)
    return trainer, state


cs.ddp_trainer = ddp_trainer
cs.out_of_bounds = lambda *args, **kwargs: []

if __name__ == "__main__":
    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    cs.build_phase()
    with cs.kernel_call_shapes() as seen:
        cs.ddp_train_path(card, seen)
    print(f"no failure in {time.time() - t0:.1f} s on {card}", flush=True)
    sys.exit(1)
