"""Train state: the three optimizer groups, the schedule and the curriculum.

The port of vid2vid_tpu/train/state.py. Reference semantics (reference:
models/models.py:86-164, models/base_model.py:154-180,
models/vid2vid_model_G.py:66-84, models/vid2vid_model_D.py:76-91):

  - the G optimizer over the generator: Adam(lr, (beta1, 0.999)), or under
    TTUR Adam(lr/2, (0, 0.9));
  - the D optimizer over the spatial discriminator and, under
    --add_face_disc, the face discriminator (not VGG, not the temporal
    discriminators): Adam(lr, (beta1, 0.999)), TTUR Adam(2lr, (0, 0.9));
  - one D_T optimizer per temporal scale, always Adam(lr, (beta1, 0.999));
  - linear lr decay after `niter` epochs over `niter_decay` epochs;
  - `niter_fix_global`: for the first N epochs only the finest generator
    scale trains; at the unfreeze the G optimizer starts afresh;
  - the curriculum: every `niter_step` epochs the clip length doubles and
    the per-step frame window and BPTT length grow.
Adam here is torch.optim.Adam (eps 1e-8), which equals optax.adam step for
step (tests/test_train_oracle.py::test_optax_adam_matches_torch).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vid2vid_tpu_torch.config import Options


@dataclasses.dataclass
class TrainState:
    """The modules being trained and their optimizers. The modules hold the
    f32 master weights; the steps update them in place."""

    gen: nn.Module
    engine: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    opt_dt: list  # one optimizer per temporal scale


@dataclasses.dataclass
class Schedule:
    """Host-side training schedule and curriculum (the JAX package's
    Schedule, field for field).

      - `n_frames_total` starts at the flag value (reference:
        data/base_dataset.py:37) and every `niter_step` epochs becomes
        `opt.n_frames_total * 2**(epoch // niter_step)`, capped at
        `min(128, seq_len_max) - (tG - 1)` (data/base_dataset.py:19-24);
      - `n_frames_per_dev` starts at `min(max_frames_per_gpu,
        opt.n_frames_total // n_dev)` and doubles toward
        `max_frames_per_gpu` (vid2vid_model_G.py:58-60, base_model.py:177-180);
      - the BPTT cadence `n_frames_bp` starts at 1 and grows as
        `n_frames_load // ceil(n_frames_load / min(max_frames_backpropagate,
        2**ratio))` (base_model.py:169-175).
    """

    opt: Options
    seq_len_max: int = 128
    epoch: int = 1
    epoch_iter: int = 0
    total_steps: int = 0
    n_frames_total: int = 6
    n_frames_per_dev: int = 1
    n_frames_load: int = 1
    n_frames_bp: int = 1
    finetune_all: bool = True

    def __post_init__(self):
        o = self.opt
        n_dev = max(o.n_devices, 1)
        # with one spatial scale nothing is ever frozen (vid2vid_model_G.py:68)
        self.finetune_all = o.niter_fix_global == 0
        self.n_frames_total = o.n_frames_total
        self.n_frames_per_dev = max(1, min(o.max_frames_per_gpu, o.n_frames_total // n_dev))
        self.n_frames_load = n_dev * self.n_frames_per_dev
        self.n_frames_bp = 1

    def lr_factor(self, epoch: int | None = None) -> float:
        """Linear decay past niter (reference: base_model.py:154-159)."""
        o = self.opt
        e = self.epoch if epoch is None else epoch
        if e <= o.niter or o.niter_decay <= 0:
            return 1.0
        return max(0.0, 1.0 - (e - o.niter) / o.niter_decay)

    def end_of_epoch(self) -> dict:
        """Advance the schedule; returns {'unfreeze': bool, 'grow': bool}
        (reference: models/models.py:151-164)."""
        o = self.opt
        n_dev = max(o.n_devices, 1)
        events = {"unfreeze": False, "grow": False}
        if (
            o.n_scales_spatial > 1
            and o.niter_fix_global != 0
            and self.epoch == o.niter_fix_global
        ):
            self.finetune_all = True
            events["unfreeze"] = True
        if self.epoch % o.niter_step == 0:
            ratio = self.epoch // o.niter_step
            cap = max(1, min(128, self.seq_len_max) - (o.n_frames_G - 1))
            old = self.n_frames_total
            if self.n_frames_total < cap:
                self.n_frames_total = min(cap, o.n_frames_total * 2**ratio)
            events["grow"] = old != self.n_frames_total
            if self.n_frames_bp < self.n_frames_load:
                nfb = min(o.max_frames_backpropagate, 2**ratio)
                self.n_frames_bp = self.n_frames_load // max(1, -(-self.n_frames_load // nfb))
            if self.n_frames_per_dev < o.max_frames_per_gpu:
                self.n_frames_per_dev = min(self.n_frames_per_dev * 2, o.max_frames_per_gpu)
                self.n_frames_load = n_dev * self.n_frames_per_dev
        self.epoch += 1
        return events


def _initial_lrs(opt: Options) -> tuple[float, float]:
    """(G lr, D lr) before any decay."""
    if opt.TTUR:
        return opt.lr / 2, opt.lr * 2
    return opt.lr, opt.lr


def _adam(params, lr: float, betas: tuple[float, float]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)


def make_g_optimizer(opt: Options, gen: nn.Module) -> torch.optim.Adam:
    betas = (0.0, 0.9) if opt.TTUR else (opt.beta1, 0.999)
    return _adam(gen.parameters(), _initial_lrs(opt)[0], betas)


def d_parameters(engine: nn.Module) -> list:
    """The D group's parameters: netD's, then netD_f's (the JAX package
    labels both "d")."""
    nets = [engine.netD] + ([engine.netD_f] if engine.netD_f is not None else [])
    return [p for net in nets for p in net.parameters()]


def create_train_state(opt: Options, gen: nn.Module, engine: nn.Module) -> TrainState:
    """The three optimizer groups with TTUR. The D group holds netD and
    netD_f: VGG is frozen and each netD_T[s] has its own always-undecayed
    Adam."""
    betas = (0.0, 0.9) if opt.TTUR else (opt.beta1, 0.999)
    opt_d = _adam(d_parameters(engine), _initial_lrs(opt)[1], betas)
    opt_dt = [
        _adam(net.parameters(), opt.lr, (opt.beta1, 0.999)) for net in engine.netD_T
    ]
    return TrainState(gen, engine, make_g_optimizer(opt, gen), opt_d, opt_dt)


def reinit_g_optimizer(state: TrainState, opt: Options) -> TrainState:
    """A fresh G Adam at the niter_fix_global unfreeze (the reference
    re-creates it, base_model.py:161-167)."""
    state.opt_g = make_g_optimizer(opt, state.gen)
    return state


def set_learning_rate(state: TrainState, opt: Options, factor: float) -> TrainState:
    """The linear-decay hook for the G and D learning rates, with the two
    reference quirks the JAX package keeps (models/models.py:151-155,
    base_model.py:154-159):
      - only the G and D optimizers decay; each D_T keeps its lr forever;
      - the decay assigns the absolute value `opt.lr * factor` to both, so
        under TTUR the lr/2 and 2*lr asymmetry vanishes at the first decay
        epoch.
    Before the decay (factor >= 1) the initial (TTUR-scaled) lrs stand."""
    lr_g, lr_d = _initial_lrs(opt) if factor >= 1.0 else (opt.lr * factor,) * 2
    for optimizer, lr in ((state.opt_g, lr_g), (state.opt_d, lr_d)):
        for group in optimizer.param_groups:
            group["lr"] = lr
    return state
