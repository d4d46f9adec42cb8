"""The training steps: generator, spatial D, temporal D.

The port of vid2vid_tpu/train/steps.py. Each chunk of `n_frames_load`
frames runs one G step, one D step and one D_T step per active temporal
scale, the reference's three backward passes (reference: train.py:84-93).
Each step differentiates its loss with respect to its own optimizer group
only (`torch.autograd.grad`), which is where the JAX package puts its
stop_gradients; every parameter of the group gets a gradient (zeros where
the loss does not reach it, as JAX gives them), then one Adam step.

Precision: f32 master weights. Under --bf16 (or --fp16) the generator's
forward runs on a bfloat16 copy of its parameters, inputs and state
(steps.py:89-115 of the JAX package), so the gradients land on the f32
masters through the cast; its outputs are cast to f32 before the losses.
The steps, forward and backward, run with cuDNN in full f32 for every f32
convolution (utils/precision.py). On a mesh (`group`: every rank,
parallel/mesh.py) each step reduces its gradients over the ranks before
the grad norm and Adam. On a model axis (`shard`) the generator, netD,
every netD_T, VGG and the losses run on each rank's columns, and each
rank's loss is its share of the whole frame's (its columns', and 1 / model
of the face losses, which netD_f computes whole on every rank of a row),
so each rank's gradient of a weight is its share's: every gradient is
summed over the model axis and averaged over the data axis (`divisor`:
the data axis's size).
"""

from __future__ import annotations

import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import ClipOutputs
from vid2vid_tpu_torch.models.loss_engine import LossEngine
from vid2vid_tpu_torch.models.temporal import skipped_frames, skipped_frames_sparse
from vid2vid_tpu_torch.parallel import halo
from vid2vid_tpu_torch.parallel.mesh import all_reduce_mean
from vid2vid_tpu_torch.train.state import TrainState
from vid2vid_tpu_torch.utils.precision import cudnn_f32


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B*T, C, H, W), contiguous."""
    return x.reshape((-1,) + x.shape[2:]).contiguous()


def _param_grad_norm(params: list[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of the gradients of `params` (weights only: running
    stats are buffers)."""
    return torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor, group=None,
           divisor: int | None = None) -> torch.Tensor:
    """Gradients of `loss` for every parameter of `optimizer`, summed over
    the ranks of `group` and divided by `divisor` (default: the group's
    size, the mean); one all-reduce of one bucket. Then the grad norm and
    one optimizer step. Returns the grad norm (a device
    scalar): the global gradient's, as JAX's over the sharded batch and
    width."""
    params = [p for pg in optimizer.param_groups for p in pg["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    all_reduce_mean([p.grad for p in params], group, divisor)
    norm = _param_grad_norm(params)
    optimizer.step()
    for p in params:
        p.grad = None
    return norm


def _bf16(opt: Options) -> bool:
    return opt.bf16 or opt.fp16


def g_step(
    state: TrainState, opt: Options,
    enc_a: torch.Tensor,        # (B, T+tG-1, C_enc, H, W)
    real_b_all: torch.Tensor,   # (B, T+tG-1, 3, H, W)
    gen_state: tuple,           # the generator's ring buffers
    flow_ref: torch.Tensor,     # (B, T, 2, H, W)
    conf_ref: torch.Tensor,     # (B, T, 1, H, W)
    fake_prev_first: torch.Tensor,  # (B, 1, 3, H, W)
    fake_buf,                   # past fakes for the temporal groups, or None
    real_skipped: list, flow_skipped: list,
    *, use_raw_only: bool, n_frames_bp: int, finetune_all: bool,
    chunk_start: int = 0, group=None, divisor: int | None = None, shard=None,
):
    """Generate the chunk, compute every G-side loss and take one Adam step
    on the generator, its gradients reduced over `group` by `divisor`
    (`_apply`). On `shard`'s columns (the model axis) the generator's
    outputs, flow_ref, conf_ref, the fake buffers and the temporal groups
    are the rank's columns, real_b_all and fake_prev_first whole (the
    warps' previous frames). Returns (loss_G, aux) with aux: outs (f32;
    on a shard the rank's columns), fake_whole (the whole fakes, f32,
    detached), gen_state, losses, t_losses, fake_buf, fake_skipped (both
    detached), grad_norm."""
    gen, engine = state.gen, state.engine
    tG, td, t_scales = opt.n_frames_G, opt.n_frames_D, opt.n_scales_temporal
    with cudnn_f32():
        params, enc, gs = None, enc_a, gen_state
        if _bf16(opt):
            bf = torch.bfloat16
            params = [
                {n: p.to(bf) for n, p in gen.scale(s).named_parameters()}
                for s in range(gen.n_scales)
            ]
            enc, gs = enc_a.to(bf), tuple(x.to(bf) for x in gen_state)
        outs, new_gen_state, fake_whole = gen.generate_clip(
            enc, gs, use_raw_only=use_raw_only, train=True,
            n_frames_bp=n_frames_bp, finetune_all=finetune_all, params=params,
            shard=shard, local=True,
        )
        if _bf16(opt):
            outs = ClipOutputs(*(None if o is None else o.float() for o in outs))
            new_gen_state = tuple(x.float() for x in new_gen_state)
            fake_whole = fake_whole.float()
        real_a = halo.local(enc_a[:, tG - 1:], shard)
        real_b = halo.local(real_b_all[:, tG - 1:], shard)
        real_b_prev = real_b_all[:, tG - 2:-1]
        fake_prev = torch.cat([fake_prev_first, fake_whole[:, :-1]], 1)
        losses = engine.generator_losses(
            _flat(real_a), _flat(real_b), _flat(outs.fake),
            None if use_raw_only else _flat(outs.raw),
            _flat(real_b_prev), _flat(fake_prev),
            None if outs.flow is None else _flat(outs.flow),
            None if outs.weight is None else _flat(outs.weight),
            _flat(flow_ref), _flat(conf_ref), shard=shard,
        )
        if opt.sparse_D:
            n_load = enc_a.shape[1] - tG + 1
            new_fake_buf, fake_skipped = skipped_frames_sparse(
                list(fake_buf), outs.fake, t_scales, td, n_load, chunk_start
            )
        else:
            new_fake_buf, fake_skipped = skipped_frames(fake_buf, outs.fake, t_scales, td)
        t_losses = [
            engine.temporal_g_losses(s, real_skipped[s], fake_skipped[s], flow_skipped[s],
                                     shard)
            for s in range(t_scales)
            if real_skipped[s] is not None and fake_skipped[s] is not None
        ]
        total = LossEngine.total_g_loss(losses, t_losses)
        grad_norm = _apply(state.opt_g, total, group, divisor)

    def detach(x):
        if isinstance(x, dict):
            return {k: v.detach() for k, v in x.items()}
        if isinstance(x, list):
            return [detach(v) for v in x]
        return None if x is None else x.detach()

    aux = dict(
        outs=ClipOutputs(*detach(list(outs))), fake_whole=fake_whole, gen_state=new_gen_state,
        losses=detach(losses), t_losses=detach(t_losses),
        fake_buf=detach(new_fake_buf), fake_skipped=detach(fake_skipped),
        grad_norm=grad_norm,
    )
    return total.detach(), aux


def d_step(state: TrainState, opt: Options, enc_a, real_b_all, fake, raw, group=None,
           divisor: int | None = None, shard=None):
    """The spatial (and face) D step on detached fakes (raw None under
    use_raw_only; on a `shard` fake and raw are the rank's columns, enc_a
    and real_b_all whole), the gradients reduced over `group` by `divisor`
    (`_apply`). Returns (loss_D, losses with
    D_grad_norm, the norm of netD's and netD_f's gradients)."""
    tG = opt.n_frames_G
    engine = state.engine
    with cudnn_f32():
        losses = engine.discriminator_losses(
            _flat(halo.local(enc_a[:, tG - 1:], shard)),
            _flat(halo.local(real_b_all[:, tG - 1:], shard)),
            _flat(fake), None if raw is None else _flat(raw), shard=shard,
        )
        loss = LossEngine.total_d_loss(losses)
        norm = _apply(state.opt_d, loss, group, divisor)
    return loss.detach(), {k: v.detach() for k, v in losses.items()} | {"D_grad_norm": norm}


def dt_step(state: TrainState, opt: Options, real_groups, fake_groups, flow_groups, *,
            scale: int, group=None, divisor: int | None = None, shard=None):
    """The temporal D step of one scale (on a `shard`, the groups are the
    rank's columns), the gradients reduced over `group` by `divisor`.
    Returns (loss_D_T, losses with D_T_grad_norm)."""
    with cudnn_f32():
        losses = state.engine.temporal_d_losses(scale, real_groups, fake_groups, flow_groups,
                                                shard)
        loss = (losses["D_T_fake"] + losses["D_T_real"]) * 0.5
        norm = _apply(state.opt_dt[scale], loss, group, divisor)
    return loss.detach(), {k: v.detach() for k, v in losses.items()} | {"D_T_grad_norm": norm}
