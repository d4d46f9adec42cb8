"""The training slice's modules against the JAX package's, on the CPU, f32.

The discriminators, VGG19 and every loss function match at 2e-4 from the
same weights (flax's init with random biases and running stats, carried
into the port with from_jax) and the same numpy inputs; the temporal
bookkeeping and the Schedule match over several chunks and epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import nchw, nhwc, randomize
from vid2vid_tpu import losses as jlosses
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models import temporal as jtemporal
from vid2vid_tpu.nn.discriminator import MultiscaleDiscriminator as JaxMultiscaleD
from vid2vid_tpu.nn.vgg import Vgg19Features as JaxVgg
from vid2vid_tpu.train import state as jstate
from vid2vid_tpu_torch import losses
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models import temporal
from vid2vid_tpu_torch.nn.discriminator import MultiscaleDiscriminator
from vid2vid_tpu_torch.nn.layers import update_running_stats
from vid2vid_tpu_torch.nn.vgg import Vgg19Features
from vid2vid_tpu_torch.train import state as tstate
from vid2vid_tpu_torch.utils.from_jax import jax_variables_to_state_dict
from vid2vid_tpu_torch.utils.mappings import multiscale_discriminator_mapping, vgg19_mapping

TOL = dict(atol=2e-4, rtol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


# ------------------------------------------------------------ discriminators


@pytest.fixture(scope="module")
def discriminators():
    """(JAX module, variables, port module) for num_D 2, n_layers_D 2,
    batch norm, intermediate features, 7 input channels."""
    rng = np.random.default_rng(3)
    jd = JaxMultiscaleD(ndf=8, n_layers=2, norm="batch", num_d=2, get_interm_feat=True)
    variables = randomize(jd.init(jax.random.key(0), jnp.zeros((1, 32, 48, 7))), rng)
    port = MultiscaleDiscriminator(7, 8, 2, "batch", 2, True)
    sd = jax_variables_to_state_dict(variables, multiscale_discriminator_mapping(2, 2, "batch"))
    port.load_state_dict(sd, strict=True)
    return jd, variables, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_matches_jax(rng, discriminators, train):
    jd, variables, port = discriminators
    x = rng.standard_normal((3, 32, 48, 7)).astype(np.float32)
    want = jd.apply(variables, jnp.asarray(x), train, mutable=False)
    update_running_stats(port, False)
    port.train(train)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(nchw(x))
    assert [len(f) for f in got] == [len(f) for f in want] == [4, 4]
    for feats_g, feats_w in zip(got, want):
        for g, w in zip(feats_g, feats_w):
            assert g.shape == nchw(np.asarray(w)).shape
            _close(g, w)
    # the patch maps are not dominated by the head's bias
    assert float(np.std(np.asarray(want[0][-1]))) > 10 * TOL["atol"]
    for k, v in port.state_dict().items():  # the step leaves the stats alone
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)


# ---------------------------------------------------------------------- VGG


@pytest.fixture(scope="module")
def vggs():
    rng = np.random.default_rng(4)
    jv = JaxVgg()
    variables = randomize(jv.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3))), rng)
    port = Vgg19Features()
    port.load_state_dict(jax_variables_to_state_dict(variables, vgg19_mapping()), strict=True)
    return jv, variables, port


def test_vgg_taps_match_jax(rng, vggs):
    jv, variables, port = vggs
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want = jv.apply(variables, jnp.asarray(x))
    got = port(nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)
    assert not any(p.requires_grad for p in port.parameters())


# -------------------------------------------------------------------- losses


def _pred(rng, n_scales=2, n_feats=3):
    """A multiscale D output: per scale, n_feats activation maps."""
    return [
        [rng.standard_normal((2, 5 + i, 7 + i, 4 if j < n_feats - 1 else 1)).astype(np.float32)
         for j in range(n_feats)]
        for i in range(n_scales)
    ]


def _to_port(pred):
    return [[nchw(a) for a in scale] for scale in pred]


def _to_jax(pred):
    return [[jnp.asarray(a) for a in scale] for scale in pred]


@pytest.mark.parametrize("mode", ["ls", "original", "hinge"])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("for_d", [True, False])
def test_gan_loss_matches_jax(rng, mode, real, for_d):
    pred = _pred(rng)
    got = losses.gan_loss(_to_port(pred), real, mode, for_discriminator=for_d)
    want = jlosses.gan_loss(_to_jax(pred), real, mode, for_discriminator=for_d)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_feature_matching_and_masked_l1_match_jax(rng):
    fake, real = _pred(rng), _pred(rng)
    got = losses.feature_matching_loss(_to_port(fake), _to_port(real), 2, 2, 10.0)
    want = jlosses.feature_matching_loss(_to_jax(fake), _to_jax(real), 2, 2, 10.0)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    a, b = (rng.standard_normal((3, 6, 9, 2)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(0, 1, (3, 6, 9, 1)).astype(np.float32)
    got = losses.masked_l1(nchw(a), nchw(b), nchw(mask))
    want = jlosses.masked_l1(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("max_width", [1024, 24], ids=["full", "pooled"])
def test_vgg_loss_matches_jax(rng, vggs, max_width):
    jv, variables, port = vggs
    x, y = (rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(2))
    got = losses.vgg_loss(port, nchw(x), nchw(y), max_width=max_width)
    want = jlosses.vgg_loss(jv.apply, variables, jnp.asarray(x), jnp.asarray(y),
                            max_width=max_width)
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------- temporal bookkeeping


def _frames(rng, b, t, c, h=3, w=4):
    return rng.standard_normal((b, t, h, w, c)).astype(np.float32)


def _same(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 2, -1), np.asarray(want))


@pytest.mark.parametrize("t_scales,td,n_load", [(2, 3, 2), (3, 2, 3), (1, 3, 4)])
def test_skipped_frames_and_flows_match_jax(rng, t_scales, td, n_load):
    buf_p = buf_j = fbuf_p = fbuf_j = cbuf_p = cbuf_j = None
    for _ in range(6):
        new = _frames(rng, 2, n_load, 3)
        flow, conf = _frames(rng, 2, n_load, 2), _frames(rng, 2, n_load, 1)
        tnew = torch.from_numpy(np.moveaxis(new, -1, 2))
        buf_p, got = temporal.skipped_frames(buf_p, tnew, t_scales, td)
        buf_j, want = jtemporal.skipped_frames(buf_j, jnp.asarray(new), t_scales, td)
        _same(buf_p, buf_j)
        for g, w in zip(got, want):
            _same(g, w)
        tf, tc = (torch.from_numpy(np.moveaxis(a, -1, 2)) for a in (flow, conf))
        fbuf_p, cbuf_p, fs_p, cs_p = temporal.skipped_flows(fbuf_p, cbuf_p, tf, tc, t_scales, td)
        fbuf_j, cbuf_j, fs_j, cs_j = jtemporal.skipped_flows(
            fbuf_j, cbuf_j, jnp.asarray(flow), jnp.asarray(conf), t_scales, td)
        for g, w in zip(fs_p + cs_p, fs_j + cs_j):
            _same(g, w)


@pytest.mark.parametrize("is_flow", [False, True])
def test_skipped_frames_sparse_match_jax(rng, is_flow):
    t_scales, td, n_load = 3, 2, 3
    buf_p, buf_j = [None] * t_scales, [None] * t_scales
    seen = 0
    for chunk in range(6):
        new = _frames(rng, 1, n_load, 2)
        tnew = torch.from_numpy(np.moveaxis(new, -1, 2))
        start = chunk * n_load
        buf_p, got = temporal.skipped_frames_sparse(
            buf_p, tnew, t_scales, td, n_load, start, is_flow)
        buf_j, want = jtemporal.skipped_frames_sparse(
            buf_j, jnp.asarray(new), t_scales, td, n_load, start, is_flow)
        for g, w in zip(buf_p + got, buf_j + want):
            _same(g, w)
        seen += sum(g is not None for g in got)
    assert seen > 6


# ------------------------------------------------------------------ schedule

SCHEDULES = [
    dict(n_frames_total=6, max_frames_per_gpu=2, niter=3, niter_decay=4, niter_step=2),
    dict(n_frames_total=4, max_frames_per_gpu=4, niter=1, niter_decay=2, niter_step=1,
         n_scales_spatial=2, niter_fix_global=2, max_frames_backpropagate=2),
    dict(n_frames_total=30, max_frames_per_gpu=1, niter=2, niter_decay=0, niter_step=3,
         TTUR=True),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["decay", "fix_global", "ttur"])
def test_schedule_matches_jax(kw):
    sp = tstate.Schedule(Options(**kw))
    sj = jstate.Schedule(JaxOptions(**kw))
    fields = ("epoch", "n_frames_total", "n_frames_per_dev", "n_frames_load",
              "n_frames_bp", "finetune_all")
    for _ in range(9):
        assert [getattr(sp, f) for f in fields] == [getattr(sj, f) for f in fields]
        assert sp.lr_factor() == sj.lr_factor()
        assert sp.end_of_epoch() == sj.end_of_epoch()


@pytest.mark.parametrize("ttur", [False, True])
def test_learning_rates_match_jax(ttur):
    """The three Adam groups' lrs and betas, and set_learning_rate's absolute
    lr quirk (D_T never decays), against the JAX optax states."""
    kw = dict(lr=2e-4, beta1=0.5, TTUR=ttur, n_scales_temporal=2)
    opt_p, opt_j = Options(**kw), JaxOptions(**kw)
    tiny = {"params": {"w": np.zeros(2, np.float32)}}
    jax_st, (g_tx, _, dt_tx) = jstate.create_train_state(
        opt_j, {"G0": tiny}, {"D": tiny, "D_T0": tiny, "D_T1": tiny, "vgg": tiny})

    class Engine(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.netD = torch.nn.Linear(2, 1)
            self.netD_f = None  # no --add_face_disc
            self.netD_T = torch.nn.ModuleList(torch.nn.Linear(2, 1) for _ in range(2))
            self.vgg = torch.nn.Linear(2, 1).requires_grad_(False)

    st = tstate.create_train_state(opt_p, torch.nn.Linear(2, 1), Engine())
    assert len(st.opt_d.param_groups[0]["params"]) == 2  # netD only

    def lrs_port():
        return [st.opt_g.param_groups[0]["lr"], st.opt_d.param_groups[0]["lr"],
                st.opt_dt[0].param_groups[0]["lr"], st.opt_dt[1].param_groups[0]["lr"]]

    def lrs_jax(s):
        return [float(s.opt_g.hyperparams["learning_rate"]),
                float(s.opt_d.inner_states["d"].inner_state.hyperparams["learning_rate"]),
                float(s.opt_dt[0].hyperparams["learning_rate"]),
                float(s.opt_dt[1].hyperparams["learning_rate"])]

    for factor in (1.0, 0.5, 0.25):
        st = tstate.set_learning_rate(st, opt_p, factor)
        jax_st = jstate.set_learning_rate(jax_st, opt_j, factor)
        np.testing.assert_allclose(lrs_port(), lrs_jax(jax_st), rtol=1e-6)
    assert st.opt_dt[0].param_groups[0]["betas"] == (0.5, 0.999)
    betas = (0.0, 0.9) if ttur else (0.5, 0.999)
    assert st.opt_g.param_groups[0]["betas"] == st.opt_d.param_groups[0]["betas"] == betas
    assert isinstance(g_tx, optax.GradientTransformation) and dt_tx is not None


def test_unported_training_options_raise():
    """The face discriminator is ported (max(1, num_D - 2) scales, in the D
    optimizer's group); the device mesh belongs to the multi-device slice
    and raises, naming ROADMAP."""
    from vid2vid_tpu_torch.models.loss_engine import LossEngine
    from vid2vid_tpu_torch.train.loop import Trainer

    small = dict(label_nc=3, ngf=4, n_downsample_G=1, n_blocks=1, ndf=4,
                 num_D=1, n_layers_D=1, no_vgg=True, isTrain=True)
    for num_d, n_face in ((1, 1), (4, 2)):
        engine = LossEngine(Options(**{**small, "num_D": num_d}, add_face_disc=True))
        assert engine.netD_f.num_d == n_face
        group = tstate.create_train_state(engine.opt, torch.nn.Linear(1, 1), engine).opt_d
        assert len(group.param_groups[0]["params"]) == len(list(engine.netD.parameters())) \
            + len(list(engine.netD_f.parameters()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(Options(**small, n_devices=2), device="cpu")
