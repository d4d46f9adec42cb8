"""The port's checkpoints (train/checkpoints.py): a bit-for-bit round trip
restored in place, the fuzzy warm-start, the file names the test CLI
reads, and the JAX train-state converter (utils/from_jax.py) held to
optax's Adam."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.train.loop import Trainer as JaxTrainer
from vid2vid_tpu.train.state import create_train_state as jax_create_train_state
from vid2vid_tpu.train.state import set_learning_rate as jax_set_learning_rate
from vid2vid_tpu_torch import test_cli
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data.synthetic import moving_square_clip
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.train import checkpoints
from vid2vid_tpu_torch.train.loop import Trainer
from vid2vid_tpu_torch.utils.from_jax import (
    generator_state_dict,
    jax_variables_to_state_dict,
    train_state_checkpoint,
)
from vid2vid_tpu_torch.utils.mappings import multiscale_discriminator_mapping

TINY = dict(label_nc=4, ngf=8, ndf=8, n_downsample_G=2, n_blocks=1, n_blocks_local=1,
            n_scales_spatial=1, n_frames_G=3, n_frames_D=3, n_scales_temporal=2, num_D=1,
            n_layers_D=2, n_frames_total=6, max_frames_per_gpu=2, no_vgg=True,
            norm="batch", no_flow=True, name="run", niter=1, niter_decay=4)


def trained(tmp_path, seed=0, clips=2, **kw):
    """A tiny CPU Trainer after `clips` clips and one end of epoch past
    niter (so the G and D lrs have decayed)."""
    opt = Options(**{**TINY, **kw}, checkpoints_dir=str(tmp_path), seed=seed)
    trainer = Trainer(opt, device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(seed)
    for _ in range(clips):
        labels, frames = (torch.from_numpy(a) for a in moving_square_clip(rng, 8, 32, 32, 4))
        state, _ = trainer.train_clip(state, labels, frames)
    trainer.schedule.epoch = opt.niter + 1
    state = trainer.end_of_epoch(state)
    return opt, trainer, state


def tensors(state) -> dict:
    """Every tensor a checkpoint holds, by name (VGG's aside)."""
    out = {f"gen.{k}": v for k, v in state.gen.state_dict().items()}
    out.update({f"engine.{k}": v for k, v in state.engine.state_dict().items()
                if not k.startswith("vgg.")})
    for name, o in [("opt_g", state.opt_g), ("opt_d", state.opt_d)] + [
            (f"opt_dt{s}", o) for s, o in enumerate(state.opt_dt)]:
        for i, st in o.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    return out


def test_round_trip_is_bit_for_bit_and_in_place(tmp_path):
    opt, trainer, state = trained(tmp_path)
    assert trainer.schedule.lr_factor() == 0.5 and trainer.schedule.epoch == 3
    checkpoints.save_checkpoint(opt, state, trainer.schedule)
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == ["iter.txt", "latest_net_D.pth", "latest_net_D_T0.pth",
                     "latest_net_D_T1.pth", "latest_net_G0.pth", "latest_optim.pth"]
    assert (tmp_path / "run" / "iter.txt").read_text() == "3 0"
    assert checkpoints.checkpoint_exists(opt) and not checkpoints.checkpoint_exists(opt, "5")

    # a fresh trainer from another seed, restored in place
    fresh = Trainer(opt.replace(seed=9), device="cpu")
    fstate = fresh.init_state()
    params = [p for p in fstate.gen.parameters()] + [p for p in fstate.engine.parameters()]
    optimizers = [fstate.opt_g, fstate.opt_d, *fstate.opt_dt]
    versions = [p._version for p in params]
    fstate, sched = checkpoints.restore_checkpoint(opt, fstate, fresh.schedule)
    assert [p for p in fstate.gen.parameters()] + [p for p in fstate.engine.parameters()] == params
    assert [fstate.opt_g, fstate.opt_d, *fstate.opt_dt] == optimizers
    assert [id(p) for g in fstate.opt_g.param_groups for p in g["params"]] == \
        [id(p) for p in fstate.gen.parameters()]
    assert all(p._version > v for p, v in zip(params, versions) if p.requires_grad)

    want, got = tensors(state), tensors(fstate)
    assert got.keys() == want.keys()
    assert any(k.endswith("exp_avg_sq") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert float(want["opt_g.0.step"]) == 6  # 2 clips x 3 chunks
    assert float(want["opt_g.0.exp_avg"].abs().max()) > 0
    for a, b in zip(optimizers, [state.opt_g, state.opt_d, *state.opt_dt]):
        assert [g["lr"] for g in a.param_groups] == [g["lr"] for g in b.param_groups]
    assert fstate.opt_g.param_groups[0]["lr"] == opt.lr * 0.5
    assert fstate.opt_dt[0].param_groups[0]["lr"] == opt.lr  # D_T never decays
    assert checkpoints.schedule_fields(sched) == checkpoints.schedule_fields(trainer.schedule)


def test_warm_start_one_scale_to_two(tmp_path, capsys):
    """--load_pretrain from a one-scale run into two scales: every G0 tensor
    loads, every G1 tensor stays at init, the skipped keys are listed; the
    discriminators load from a full checkpoint and are left from a
    generator-only one."""
    src_opt, _, src_state = trained(tmp_path / "src", clips=1)
    checkpoints.save_checkpoint(src_opt, src_state, Trainer(src_opt, device="cpu").schedule)
    saved = {k: v.clone() for k, v in tensors(src_state).items()}
    root = str(tmp_path / "src" / "run")
    for full in (True, False):
        if not full:
            for f in os.listdir(root):
                if "net_D" in f:
                    os.remove(os.path.join(root, f))
        opt = Options(**{**TINY, "n_scales_spatial": 2}, load_pretrain=root, seed=4)
        trainer = Trainer(opt, device="cpu")
        state = trainer.init_state()
        init = {k: v.clone() for k, v in tensors(state).items()}
        capsys.readouterr()
        checkpoints.load_pretrain(opt, state)
        out = capsys.readouterr().out
        got = tensors(state)
        g0 = [k for k in got if k.startswith("gen.G0.")]
        g1 = [k for k in got if k.startswith("gen.G1.")]
        assert g0 and g1
        assert all(torch.equal(got[k], saved[k]) for k in g0)
        assert all(torch.equal(got[k], init[k]) for k in g1)
        d_keys = [k for k in got if k.startswith("engine.")]
        assert all(torch.equal(got[k], (saved if full else init)[k]) for k in d_keys)
        head = f"load_pretrain: {len(g0)} generator tensors from {root}"
        assert out.splitlines()[0] == head + (f", {len(d_keys)} discriminator tensors"
                                              if full else "")
        assert f"  not initialized from pretrain ({len(g1)}):" in out
        listed = [line.strip() for line in out.splitlines()[2:14]]
        assert listed == [k[len("gen."):] for k in g1[:12]]
        assert f"... +{len(g1) - 12} more" in out
    with pytest.raises(FileNotFoundError, match="latest_net_G0.pth"):
        checkpoints.load_pretrain(opt.replace(load_pretrain=str(tmp_path)), state)


def test_saved_generator_loads_in_the_test_cli(tmp_path):
    """<tag>_net_G<s>.pth are the files test_cli.load_weights reads."""
    opt, trainer, state = trained(tmp_path, clips=1, n_scales_spatial=2)
    checkpoints.save_checkpoint(opt, state, trainer.schedule, tag="7")
    eng = InferenceEngine(opt.replace(isTrain=False, which_epoch="7"), device="cpu")
    assert test_cli.load_weights(eng.opt, eng)
    want = state.gen.state_dict()
    for k, v in eng.gen.state_dict().items():
        assert torch.equal(v, want[k]), k


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """A JAX train state with nonzero Adam moments (three optax steps of
    random gradients, the G and D lrs decayed) -> the port's checkpoint ->
    a port Trainer; one more step of the same random gradients through
    optax's Adam and through torch's agrees to 1e-6."""
    config = {**tp.CONFIG, "no_vgg": True}
    jopt = JaxOptions(**config)
    jax_trainer = JaxTrainer(jopt)
    rng = np.random.default_rng(0)
    gparams, dparams = (tp.init_like(jax.eval_shape(init, jax.random.key(0)), rng) for init in (
        lambda k: jax_trainer.gen.init(k, 1, tp.H, tp.W),
        lambda k: jax_trainer.engine.init(k, tp.H, tp.W)))
    jstate, (g_tx, d_tx, dt_tx) = jax_create_train_state(jopt, gparams, dparams)
    opt = Options(**config, checkpoints_dir=str(tmp_path), name="from_jax")

    def grads_like(tree):  # weights' gradients; the norms' statistics get none
        def leaf(path, x):
            stats = any(getattr(k, "key", None) == "batch_stats" for k in path)
            return np.zeros_like(x) if stats else rng.standard_normal(x.shape).astype(np.float32)
        return jax.tree_util.tree_map_with_path(leaf, tree)

    @jax.jit
    def jax_step(st, grads):
        g, d, dt = grads
        upd, opt_g = g_tx.update(g, st.opt_g, st.gparams)
        gparams = optax.apply_updates(st.gparams, upd)
        upd, opt_d = d_tx.update(d, st.opt_d, st.dparams)
        dparams = optax.apply_updates(st.dparams, upd)
        upd, opt_dt0 = dt_tx.update(dt, st.opt_dt[0], dparams["D_T0"])
        dparams = {**dparams, "D_T0": optax.apply_updates(dparams["D_T0"], upd)}
        return st.replace(gparams=gparams, dparams=dparams, opt_g=opt_g, opt_d=opt_d,
                          opt_dt=(opt_dt0,))

    def draw():
        return (grads_like(jstate.gparams), grads_like(jstate.dparams),
                grads_like(jstate.dparams["D_T0"]))

    for _ in range(3):
        jstate = jax_step(jstate, draw())
    jstate = jax_set_learning_rate(jstate, jopt, 0.25)
    schedule = {"epoch": 4, "epoch_iter": 0, "total_steps": 3, "n_frames_total": 6,
                "n_frames_per_dev": 3, "n_frames_load": 3, "n_frames_bp": 1,
                "seq_len_max": 30, "finetune_all": True}
    payload = _numpy({"gparams": jstate.gparams, "dparams": jstate.dparams,
                      "opt_g": jstate.opt_g, "opt_d": jstate.opt_d,
                      "opt_dt": list(jstate.opt_dt), "schedule": schedule})
    checkpoints.write_checkpoint(opt, train_state_checkpoint(payload, opt))

    trainer = Trainer(opt, device="cpu")
    state, sched = checkpoints.restore_checkpoint(opt, trainer.init_state(), trainer.schedule)
    assert checkpoints.schedule_fields(sched) == schedule
    assert state.opt_g.param_groups[0]["lr"] == pytest.approx(tp.LR * 0.25)
    assert state.opt_d.param_groups[0]["lr"] == pytest.approx(tp.LR * 0.25)
    assert state.opt_dt[0].param_groups[0]["lr"] == pytest.approx(tp.LR)
    assert float(state.opt_g.state_dict()["state"][0]["step"]) == 3

    grads = draw()
    jstate = jax_step(jstate, grads)
    d_map = multiscale_discriminator_mapping(opt.num_D, opt.n_layers_D, opt.norm)
    g_grad = generator_state_dict(_numpy(grads[0]), opt)
    d_grad = jax_variables_to_state_dict(_numpy(grads[1]["D"]), d_map)
    dt_grad = jax_variables_to_state_dict(_numpy(grads[2]), d_map)
    for optimizer, module, grad in ((state.opt_g, state.gen, g_grad),
                                    (state.opt_d, state.engine.netD, d_grad),
                                    (state.opt_dt[0], state.engine.netD_T[0], dt_grad)):
        for name, p in module.named_parameters():
            p.grad = grad[name]
        optimizer.step()
    want = generator_state_dict(_numpy(jstate.gparams), opt)
    for k, v in state.gen.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    for net, tree in ((state.engine.netD, jstate.dparams["D"]),
                      (state.engine.netD_T[0], jstate.dparams["D_T0"])):
        want = jax_variables_to_state_dict(_numpy(tree), d_map)
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
