"""The face discriminator (--add_face_disc) against the JAX package's, on
the CPU, in f32: the face box, the G and D losses with D_f and D_f's
gradients (found and not found, DensePose and OpenPose keys), a Trainer
chunk through tests/torch_parity.py under its bounds, the checkpoint
round trip with net_D_f.pth, and the JAX train-state converter's D_f
moments against optax's Adam."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.loss_engine import LossEngine as JaxLossEngine
from vid2vid_tpu.train.loop import Trainer as JaxTrainer
from vid2vid_tpu.train.state import create_train_state as jax_create_train_state
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.loss_engine import LossEngine
from vid2vid_tpu_torch.nn.layers import update_running_stats
from vid2vid_tpu_torch.train import checkpoints
from vid2vid_tpu_torch.train.loop import Trainer
from vid2vid_tpu_torch.utils.from_jax import (
    face_discriminator_mapping,
    jax_variables_to_state_dict,
    loss_engine_state_dict,
    train_state_checkpoint,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    with tp.torch_threads(1):
        yield


FACE_KEYS = ("G_f_GAN", "G_f_GAN_Feat", "D_f_real", "D_f_fake")
# pose conditioning (6 channels), a 16-square face window (fineSize 64)
SMALL = dict(label_nc=0, input_nc=6, output_nc=3, ndf=8, num_D=3, n_layers_D=2,
             norm="batch", no_vgg=True, add_face_disc=True, fineSize=64, isTrain=True,
             n_scales_temporal=1)
N, H, W = 2, 40, 56
TOL = dict(rtol=2e-4, atol=2e-4)


def conditioning(rng, openpose: bool, found: bool, n=N, h=H, w=W) -> np.ndarray:
    """(n, h, w, 6) pose conditioning in [-1, 1] below every face key, with
    (when `found`) a face patch: DensePose part index > 0.9 in channel 2, or
    OpenPose's face colour (0.2, -1, -0.6) in channels 0-2."""
    a = rng.uniform(-1, 0.8, (n, h, w, 6)).astype(np.float32)
    a[..., 1] = np.maximum(a[..., 1], -0.9)  # no accidental OpenPose key
    if found:
        y, x = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 6))
        if openpose:
            a[-1, y : y + 5, x : x + 4, :3] = [0.2, -1.0, -0.6]
        else:
            a[0, y : y + 6, x : x + 3, 2] = 0.95
            a[-1, y + 2 : y + 4, x + 4, 2] = 0.99
    return a


@pytest.mark.parametrize("openpose", [False, True], ids=["densepose", "openpose"])
@pytest.mark.parametrize("found", [True, False], ids=["found", "none"])
def test_face_region_matches_jax(openpose, found):
    rng = np.random.default_rng(1)
    kw = dict(SMALL, openpose_only=openpose)
    jeng, peng = JaxLossEngine(JaxOptions(**kw)), LossEngine(Options(**kw))
    for _ in range(5):
        a = conditioning(rng, openpose, found)
        want = [int(v) for v in jeng.face_region(jnp.asarray(a))]
        got = [int(v) for v in peng.face_region(tp.nchw(a))]
        assert got == want and bool(want[0]) == found
        size = 64 // 32 * 8
        crop = peng._crop_face(tp.nchw(a), *(torch.tensor(v) for v in got[1:]))
        np.testing.assert_array_equal(
            tp.nhwc(crop), np.asarray(jeng._crop_face(jnp.asarray(a), *want[1:])))
        assert crop.shape[-2:] == (size, size)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, its randomized params, port engine with those weights)."""
    jopt = JaxOptions(**SMALL)
    jeng = JaxLossEngine(jopt)
    rng = np.random.default_rng(2)
    init = jax.jit(jeng.init, static_argnums=(1, 2))
    params = {k: tp.randomize(v, rng) for k, v in init(jax.random.key(0), H, W).items()}
    peng = LossEngine(Options(**SMALL))
    peng.load_state_dict(loss_engine_state_dict(params, Options(**SMALL)), strict=True)
    peng.train()
    update_running_stats(peng, False)
    g_losses = jax.jit(lambda p, x, fr, cf: jeng.generator_losses(
        p, *x, None, None, fr, cf, train=True))
    d_losses = jax.jit(lambda p, *x: jeng.discriminator_losses(p, *x, train=True))
    d_grad = jax.jit(jax.grad(lambda p, *x: JaxLossEngine.total_d_loss(d_losses(p, *x))))
    return jeng, params, peng, (g_losses, d_losses, d_grad)


def _d_f_grads(tree: dict, params: dict) -> dict:
    """JAX D_f gradients -> the port's state-dict names (weights only)."""
    sd = jax_variables_to_state_dict({"params": tree["params"],
                                      "batch_stats": params["D_f"]["batch_stats"]},
                                     face_discriminator_mapping(Options(**SMALL)))
    return {k: v for k, v in sd.items() if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("found", [True, False], ids=["found", "none"])
def test_face_losses_and_gradients_match_jax(engines, found):
    """Every G and D loss with the face terms (weight 2; zero without a
    face) and the totals at 2e-4; D_f's gradient of the D total against
    jax.grad's: equal where found, exactly zero (as lax.cond gives) where
    not."""
    jeng, params, peng, (g_losses, d_losses, d_grad) = engines
    rng = np.random.default_rng(3 + found)
    a = conditioning(rng, False, found)
    rb, fb, raw, rbp, fbp = (rng.uniform(-1, 1, (N, H, W, 3)).astype(np.float32)
                             for _ in range(5))
    flow_ref = rng.uniform(-2, 2, (N, H, W, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, (N, H, W, 1)).astype(np.float32)
    j = [jnp.asarray(x) for x in (a, rb, fb, raw, rbp, fbp)]
    want_g = g_losses(params, j, jnp.asarray(flow_ref), jnp.asarray(conf))
    want_d = d_losses(params, *j[:4])
    t = [tp.nchw(x) for x in (a, rb, fb, raw, rbp, fbp)]
    got_g = peng.generator_losses(*t, None, None, tp.nchw(flow_ref), tp.nchw(conf))
    got_d = peng.discriminator_losses(t[0], t[1], t[2], t[3])
    for got, want in ((got_g, want_g), (got_d, want_d)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]), **TOL,
                                       err_msg=k)
    assert all((float(got_g[k].detach()) != 0) == found for k in FACE_KEYS[:2])
    assert all((float(got_d[k].detach()) != 0) == found for k in FACE_KEYS[2:])
    np.testing.assert_allclose(float(LossEngine.total_g_loss(got_g, []).detach()),
                               float(JaxLossEngine.total_g_loss(want_g, [])), **TOL)

    want_grad = _d_f_grads(d_grad(params, *j[:4])["D_f"], params)
    peng.zero_grad()
    total = LossEngine.total_d_loss(got_d)
    np.testing.assert_allclose(float(total.detach()),
                               float(JaxLossEngine.total_d_loss(want_d)), **TOL)
    total.backward()
    got_grad = dict(peng.netD_f.named_parameters())
    assert got_grad.keys() == want_grad.keys()
    for k, v in want_grad.items():
        g = got_grad[k].grad
        assert g is not None, k
        if found:
            np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=2e-3, atol=2e-5, err_msg=k)
        else:
            assert not g.any() and not v.numpy().any(), k


def test_trainer_chunks_with_face_disc_match_jax():
    """A chunk of the Trainer with --add_face_disc against the JAX
    Trainer (torch_parity's clip: the one-hot label 2 is channel 2 of the
    conditioning, > 0.9 on its pixels, so the face window is found; a
    16-square window; VGG off, which test_torch_train.py covers), every
    loss and grad norm within the file's chunk-1 bounds."""
    kw = dict(add_face_disc=True, fineSize=64, no_vgg=True)  # VGG: tests/test_torch_train.py
    want, _, jax_init = tp.run_jax(1, n_chunks=1, **kw)
    got, (_, eng_sd) = tp.run_port(jax_init, 1, n_chunks=1, **kw)
    assert tp.losses_within(got, want, FACE_KEYS) == []
    assert all(got[0][k] != 0 for k in FACE_KEYS)
    assert any(k.startswith("netD_f.") for k in eng_sd)


def pose_clip(rng, t=5, h=32, w=32, face=True):
    """(conditioning (1, t, 6, h, w) float32, frames (1, t, 3, h, w)); with
    `face`, a face patch in every frame."""
    a = np.stack([conditioning(rng, False, False, t, h, w)])
    if face:
        a[0, :, 10:16, 12:18, 2] = 0.95
    return (torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 2))),
            torch.from_numpy(rng.uniform(-1, 1, (1, t, 3, h, w)).astype(np.float32)))


def test_checkpoint_round_trip_with_face_disc(tmp_path):
    """net_D_f.pth is saved and restored bit for bit in place with the D
    Adam's moments over netD and netD_f; a state without the face
    discriminator refuses the checkpoint; the warm-start loads D_f."""
    opt = Options(**{**SMALL, "n_scales_temporal": 1}, ngf=8, n_downsample_G=2, n_blocks=1,
                  n_scales_spatial=1, n_frames_G=3, n_frames_D=3, n_frames_total=4,
                  max_frames_per_gpu=2, no_flow=True, checkpoints_dir=str(tmp_path), name="run")
    trainer = Trainer(opt, device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(4)
    for face in (True, False):
        state, losses = trainer.train_clip(state, *pose_clip(rng, face=face))
        assert (losses["D_f_real"] != 0) == face
    checkpoints.save_checkpoint(opt, state, trainer.schedule)
    assert "latest_net_D_f.pth" in os.listdir(tmp_path / "run")

    fresh = Trainer(opt.replace(seed=3), device="cpu")
    fstate = fresh.init_state()
    fstate, _ = checkpoints.restore_checkpoint(opt, fstate, fresh.schedule)
    for k, v in state.engine.netD_f.state_dict().items():
        assert torch.equal(fstate.engine.netD_f.state_dict()[k], v), k
    want, got = state.opt_d.state_dict()["state"], fstate.opt_d.state_dict()["state"]
    n_d = len(list(state.engine.netD.parameters()))
    assert len(want) == len(got) == n_d + len(list(state.engine.netD_f.parameters()))
    for i in want:
        for k in want[i]:
            assert torch.equal(got[i][k], want[i][k]), (i, k)
    assert float(want[n_d]["exp_avg"].abs().max()) > 0  # D_f's moments moved

    plain = Trainer(opt.replace(add_face_disc=False), device="cpu")
    with pytest.raises(ValueError, match="add_face_disc"):
        checkpoints.restore_checkpoint(opt, plain.init_state(), plain.schedule)
    warm = Trainer(opt.replace(load_pretrain=str(tmp_path / "run"), seed=5), device="cpu")
    wstate = checkpoints.load_pretrain(warm.opt, warm.init_state())
    for k, v in state.engine.netD_f.state_dict().items():
        assert torch.equal(wstate.engine.netD_f.state_dict()[k], v), k


def test_jax_train_state_with_face_disc_resumes_in_the_port(tmp_path):
    """A JAX train state with D_f (two optax steps of random gradients) ->
    the port's checkpoint: the D Adam's moments of D_f equal optax's, and
    one more step of the same gradients agrees to 1e-6 on D_f."""
    config = {**tp.CONFIG, "no_vgg": True, "add_face_disc": True, "fineSize": 64}
    jopt = JaxOptions(**config)
    jax_trainer = JaxTrainer(jopt)
    rng = np.random.default_rng(0)
    gparams, dparams = (tp.init_like(jax.eval_shape(init, jax.random.key(0)), rng) for init in (
        lambda k: jax_trainer.gen.init(k, 1, tp.H, tp.W),
        lambda k: jax_trainer.engine.init(k, tp.H, tp.W)))
    jstate, (_, d_tx, _) = jax_create_train_state(jopt, gparams, dparams)
    opt = Options(**config, checkpoints_dir=str(tmp_path), name="from_jax")

    def draw():  # random gradients for D_f's weights, zeros elsewhere
        def leaf(path, x):
            weight = path[0].key == "D_f" and path[1].key == "params"
            return rng.standard_normal(x.shape).astype(np.float32) if weight else np.zeros_like(x)
        return jax.tree_util.tree_map_with_path(leaf, jstate.dparams)

    @jax.jit
    def d_step(st, grads):
        upd, opt_d = d_tx.update(grads, st.opt_d, st.dparams)
        return st.replace(dparams=optax.apply_updates(st.dparams, upd), opt_d=opt_d)

    for _ in range(2):
        jstate = d_step(jstate, draw())
    payload = jax.tree.map(np.asarray, {
        "gparams": jstate.gparams, "dparams": jstate.dparams, "opt_g": jstate.opt_g,
        "opt_d": jstate.opt_d, "opt_dt": list(jstate.opt_dt),
        "schedule": {f: 1 for f in checkpoints.SCHEDULE_FIELDS}})
    files = train_state_checkpoint(payload, opt)
    assert "net_D_f" in files
    checkpoints.write_checkpoint(opt, files)
    trainer = Trainer(opt, device="cpu")
    state, _ = checkpoints.restore_checkpoint(opt, trainer.init_state(), trainer.schedule)

    f_map = face_discriminator_mapping(opt)
    adam = jstate.opt_d.inner_states["d"].inner_state.inner_state[0]
    mu = jax_variables_to_state_dict(jax.tree.map(np.asarray, {
        "params": adam.mu["D_f"]["params"], "batch_stats": dparams["D_f"]["batch_stats"]}), f_map)
    n_d = len(list(state.engine.netD.parameters()))
    sd = state.opt_d.state_dict()["state"]
    for i, (name, _) in enumerate(state.engine.netD_f.named_parameters()):
        np.testing.assert_array_equal(sd[n_d + i]["exp_avg"].numpy(), mu[name].numpy(), name)
        assert float(sd[n_d + i]["step"]) == 2

    grads = draw()
    jstate = d_step(jstate, grads)
    g = jax_variables_to_state_dict(jax.tree.map(np.asarray, {
        "params": grads["D_f"]["params"], "batch_stats": dparams["D_f"]["batch_stats"]}), f_map)
    for p in state.opt_d.param_groups[0]["params"]:
        p.grad = torch.zeros_like(p)
    for name, p in state.engine.netD_f.named_parameters():
        p.grad = g[name]
    state.opt_d.step()
    want = jax_variables_to_state_dict(jax.tree.map(np.asarray, jstate.dparams["D_f"]), f_map)
    for k, v in state.engine.netD_f.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
