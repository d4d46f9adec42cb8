"""Training's model axis (vid2vid_tpu_torch/parallel/halo.py, the
width-sharded generator in Trainer) on the CPU.

  - One process, no ranks: N = 2 and 4 shards of a frame, each on a thread
    of a parallel.collectives.LocalGroup (the collectives answered in
    memory), against the whole tensor in f32:
      - halo.padded, forward and backward, against halo.padded_plain;
      - every train-mode layer that reads across columns or normalises
        over them (the reflection pads ahead of the 3x3 and 7x7 convs, the
        down and transposed up convs, batch norm over the group, instance
        norm over the model axis, the residual block): forward, input
        gradient and the shards' weight gradients summed;
      - warp_blend_at's plain backward at each shard's offset against
        warp_blend's on the whole frame (d_prev summed over the shards);
      - one composite scale: its parameter gradients summed over the shards
        against the unsharded scale's, rtol 1e-5 (and 1e-5 of the largest
        gradient absolute: the biases ahead of a norm have a gradient of
        zero give or take a rounding), its previous frames gathered from
        the shards' columns so that their gradient keeps the invariant;
      - generate_clip over 4 frames with BPTT across 3 (remat on, 1 and 2
        scales, no norm: every sum in one order), frames bit for bit and
        parameter gradients within 1e-5.
  - One launch of 2 gloo ranks (data 1 x model 2, tests/torch_ranks.py::
    run_all): two chunks of Trainer.train_chunk against the JAX Trainer on
    its model = 2 mesh (Options(n_devices=2, batchSize=1)) from the same
    weights (utils/from_jax.py), within tests/torch_parity.py::
    losses_within; the ranks' weights equal bit for bit after each chunk;
    the exchanges' backward dropping the halos' gradient leaves those
    bounds.
  - One launch of 4 gloo ranks (data 2 x model 2, batch 2) against the
    port's one-process Trainer, within the same bounds, with BPTT across
    the chunk's frames (the warp's shared previous frame).
The JAX Trainer compiles in this process while the ranks run.
"""

import concurrent.futures
import copy
import functools

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
import torch_ranks
from test_torch_parallel import _draw, _jax_chunks
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.parallel import replicated as jax_replicated
from vid2vid_tpu.train.loop import Trainer as JaxTrainer
from vid2vid_tpu.train.state import create_train_state
from vid2vid_tpu.train.steps import make_d_step, make_dt_step, make_g_step
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import (
    BatchNorm2d,
    Conv2d,
    DownConv2d,
    FoldedReflectionPad2d,
    InstanceNorm2d,
    ReflectConv7,
    ReflectionPad2d,
    UpConvTranspose2d,
    init_weights,
    sync_batch_norm,
    update_running_stats,
)
from vid2vid_tpu_torch.ops.warp import (
    warp_blend,
    warp_blend_at,
    warp_blend_at_backward_plain,
    warp_blend_backward_plain,
)
from vid2vid_tpu_torch.parallel import halo, launch
from vid2vid_tpu_torch.parallel.collectives import LocalGroup
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict, loss_engine_state_dict

DEADLINE_S = 120.0
# the JAX side's compile dominates the ranks' part: one residual block, one
# D scale, no VGG (tests/test_torch_parallel.py's)
SMALL = dict(no_vgg=True, num_D=1, n_blocks=1)
WIDTH = 32  # the one-process cases' frames


@pytest.fixture(autouse=True)
def one_thread():
    with tp.torch_threads(1):
        yield


def _seeded(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def on_shards(n: int, width: int, fn, height: int = 1) -> list:
    """fn(shard) on each of n shards of frames width x height, each on a
    thread of one LocalGroup (its member); their results in shard order."""
    group = LocalGroup(n)

    def member(i):
        with group.member(i):
            return fn(halo.make_shard(i, n, width, group, height))

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        return [f.result() for f in [pool.submit(member, i) for i in range(n)]]


def _cases(old: dict, new: list):
    """The cases of a test by their old ids, then new ones: unequal shards,
    1-column shards under halos that span ranks, shards with no columns."""
    return [pytest.param(*c, id=i) for i, c in old.items()] + [
        pytest.param(*c, id=f"{c[-1]}_on_{c[0]}") for c in new]


def _close(got, want, scale=None):
    """rtol 1e-5; atol 1e-5 of `scale` (default: want's largest value)."""
    scale = float(want.abs().max()) if scale is None else scale
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------------ halos, one process


@pytest.mark.parametrize("n,width", _cases({"2": (2, WIDTH), "4": (4, WIDTH)},
                                           [(4, 10), (8, 8), (8, 4)]))
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_padded_on_shards_equals_its_plain_version(mode, n, width):
    """halo.padded on each shard (its halos by the exchange, their gradient
    sent back by its backward) against halo.padded_plain of the whole
    tensor: the padded columns bit for bit, and the whole input's gradient
    the shards' gradients side by side, with halos of 3 on the left and 1
    on the right (from up to three ranks on 1-column shards, reflected at
    a narrow edge shard into its neighbours' columns)."""
    x = _seeded(1, 2, 3, width)
    xw = x.clone().requires_grad_(True)
    pads = [halo.padded_plain(xw, halo.make_shard(i, n, width), 3, 1, mode) for i in range(n)]
    cots = [_seeded(*p.shape, seed=10 + i) for i, p in enumerate(pads)]
    (want,) = torch.autograd.grad(sum((p * c).sum() for p, c in zip(pads, cots)), [xw])

    def run(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        got = halo.padded(xl, sh, 3, 1, mode)
        assert torch.equal(got, pads[sh.index].detach())
        return torch.autograd.grad((got * cots[sh.index]).sum(), [xl])[0]

    torch.testing.assert_close(torch.cat(on_shards(n, width, run), -1), want, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n,width", [(2, WIDTH), (4, 10), (8, 8), (8, 4)],
                         ids=["32_on_2", "10_on_4", "8_on_8", "4_on_8"])
def test_gather_width_on_shards_equals_the_whole(n, width):
    """halo.gather_width of each shard's columns (unequal, 1-column or
    none) is the whole tensor on every shard; its backward keeps each
    shard's columns of the whole gradient."""
    x, cot = _seeded(1, 2, 3, width), _seeded(1, 2, 3, width, seed=1)

    def run(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        whole = halo.gather_width(xl, sh)
        assert torch.equal(whole, x)
        return torch.autograd.grad((whole * cot).sum(), [xl])[0]

    assert torch.equal(torch.cat(on_shards(n, width, run, 3), -1), cot)


# ------------------------------------------------------ layers, one process

LAYERS = {
    "reflect_pad_conv3": lambda: torch.nn.Sequential(ReflectionPad2d(1), Conv2d(4, 4, 3)),
    "folded_pad_conv7": lambda: torch.nn.Sequential(FoldedReflectionPad2d(), ReflectConv7(4, 3)),
    "down_conv": lambda: DownConv2d(4, 3, 3, stride=2, padding=1),
    "up_conv": lambda: UpConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1),
    "batch_norm": lambda: BatchNorm2d(4),
    "instance_norm": lambda: InstanceNorm2d(4, affine=False, track_running_stats=True),
    "resnet_block": lambda: ResnetBlock(4),
}


@pytest.mark.parametrize("n,width", _cases({"2": (2, WIDTH), "4": (4, WIDTH)},
                                           [(4, 10), (8, 8), (8, 4)]))
@pytest.mark.parametrize("name", list(LAYERS))
def test_a_train_mode_layer_on_shards_equals_the_whole(name, n, width):
    """Each shard runs the layer on its columns under halo.sharded (batch
    norm over the shards' group), x level 1 of frames 2 width x 12: its
    output is the whole output's columns of the output's level (the down
    conv's a level below, the up conv's above, each split by its own
    rule), the shards' input gradients are the whole input's, and their
    weight gradients sum to the whole layer's."""
    layer = LAYERS[name]()
    init_weights(layer, torch.Generator().manual_seed(0))
    layer.train()
    update_running_stats(layer, False)
    x = _seeded(2, 4, 6, width)
    xw = x.clone().requires_grad_(True)
    y = layer(xw)
    cot = _seeded(*y.shape, seed=3)
    params = list(layer.parameters())
    want = torch.autograd.grad((y * cot).sum(), [xw] + params)

    def run(sh):
        m = copy.deepcopy(layer)
        sync_batch_norm(m, sh.group)
        xl = sh.level_of(x).local(x).clone().requires_grad_(True)
        with halo.sharded(sh):
            yl = m(xl)
        cols = slice(*sh.level_of(y).bounds(sh.index))
        torch.testing.assert_close(yl, y.detach()[..., cols], rtol=1e-5, atol=1e-5)
        return torch.autograd.grad((yl * cot[..., cols]).sum(), [xl] + list(m.parameters()),
                                   allow_unused=True)

    out = [[torch.zeros_like(w) if g is None else g for g, w in zip(o, want)]
           for o in on_shards(n, 2 * width, run, 12)]
    _close(torch.cat([o[0] for o in out], -1), want[0])
    scale = max(float(g.abs().max()) for g in want[1:]) if params else None
    for i, w in enumerate(want[1:]):
        _close(sum(o[1 + i] for o in out), w, scale)


@pytest.mark.parametrize("n,width", _cases({"2": (2, WIDTH), "4": (4, WIDTH)}, [(8, 4)]))
def test_instance_norm_running_stats_on_shards_equal_the_whole(n, width):
    """Train-mode instance norm with its running stats updated: every shard
    (one with no columns too) takes the whole width's statistics, as
    F.instance_norm does."""
    whole = InstanceNorm2d(4, affine=False, track_running_stats=True).train()
    x = 1.0 + 2.0 * _seeded(2, 4, 6, width)
    whole(x)

    def run(sh):
        m = InstanceNorm2d(4, affine=False, track_running_stats=True).train()
        with halo.sharded(sh):
            m(sh.local(x))
        return m.running_mean, m.running_var

    for mean, var in on_shards(n, width, run, 6):
        torch.testing.assert_close(mean, whole.running_mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(var, whole.running_var, rtol=1e-5, atol=1e-6)


def test_a_batch_norm_on_a_shard_without_a_group_raises():
    with halo.sharded(halo.make_shard(0, 2, 16, height=4)), pytest.raises(ValueError,
                                                                          match="group"):
        BatchNorm2d(2).train()(torch.zeros(1, 2, 4, 8))


# --------------------------------------------------------- the warp's VJP


def _warp_inputs(width: int):
    raw, prev = _seeded(2, 3, 8, width), _seeded(2, 3, 8, width, seed=1)
    flow = 6.0 * _seeded(2, 2, 8, width, seed=2)  # samples past the shards and the borders
    flow[:, :, :2] = torch.round(flow[:, :, :2])  # integer points: JAX's half gradient
    weight = torch.sigmoid(_seeded(2, 1, 8, width, seed=3))
    return raw, prev, flow, weight, _seeded(2, 3, 8, width, seed=4)


@pytest.mark.parametrize("n,width", _cases({"2": (2, 48), "4": (4, 48)}, [(4, 10), (8, 4)]))
def test_the_warp_backward_at_an_offset_equals_the_whole(n, width):
    """warp_blend_at_backward_plain on each shard's columns: d_raw, d_flow,
    d_weight are the whole backward's columns, and the shards' d_prev
    (each over the whole frame) sum to the whole's; the autograd of
    warp_blend_at gives the same. At x0 = 0 with the whole width it is
    warp_blend's backward bit for bit; with no columns, d_prev is zeros."""
    raw, prev, flow, weight, g = _warp_inputs(width)
    want = warp_blend_backward_plain(raw, prev, flow, weight, g)
    at0 = warp_blend_at_backward_plain(raw, prev, flow, weight, g, 0)
    assert all(torch.equal(a, b) for a, b in zip(at0, want))
    dprev = torch.zeros_like(prev)
    for sh in (halo.make_shard(i, n, width) for i in range(n)):
        local = [sh.local(t).contiguous() for t in (raw, flow, weight, g)]
        got = warp_blend_at_backward_plain(local[0], prev, local[1], local[2], local[3], sh.x0)
        for k in (0, 2, 3):
            torch.testing.assert_close(got[k], sh.local(want[k]), rtol=0, atol=1e-6)
        dprev += got[1]
        leaves = [t.clone().requires_grad_(True) for t in (local[0], prev, local[1], local[2])]
        out = warp_blend_at(*leaves, sh.x0)
        auto = torch.autograd.grad((out * local[3]).sum(), leaves)
        for a, b in zip(auto, got):
            assert torch.equal(a, b)
    torch.testing.assert_close(dprev, want[1], rtol=0, atol=1e-5)
    whole = [t.clone().requires_grad_(True) for t in (raw, prev, flow, weight)]
    auto = torch.autograd.grad((warp_blend(*whole) * g).sum(), whole)
    assert all(torch.equal(a, b) for a, b in zip(auto, want))


# ----------------------------------------------- the generator, one process

SCALE_OPT = dict(label_nc=4, use_instance=False, output_nc=3, ngf=8, n_downsample_G=2,
                 n_blocks=2, n_blocks_local=1, n_scales_spatial=1, n_frames_G=3,
                 norm="batch", fg=True, fg_labels=(3,), isTrain=True)


@pytest.mark.parametrize("n,w", _cases({"2": (2, 64), "4": (4, 64)}, [(4, 40), (8, 16)]))
def test_a_composite_scale_on_shards_equals_the_whole(n, w):
    """G0 in train mode (batch norm over the shards, the fg branch, the
    blend through warp_blend_at) on each shard's columns, its previous
    frames gathered from the shards' columns (halo.gather_width) and every
    output gathered into one replicated loss: the previous frames' and
    every parameter's gradients, summed over the shards, against the
    unsharded scale's (at 40 on 4 the trunk's 10 columns split 2 / 3; at
    16 on 8 its 4 leave half the shards without one)."""
    h = 16
    gen = Vid2VidGenerator(Options(**SCALE_OPT))
    init_weights(gen, torch.Generator().manual_seed(0))
    gen.train()
    update_running_stats(gen, False)
    rng = np.random.default_rng(0)
    lab, prev = (torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32))
                 for c in (12, 6))
    mask = torch.from_numpy((rng.random((1, 1, h, w)) > 0.5).astype(np.float32))
    cots = [torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32))
            for c in (3, 3, 2, 1)]

    def loss(out, gather):
        outs = (out.img_final, out.img_raw, out.flow, out.weight)
        return sum((gather(o) * c).sum() for o, c in zip(outs, cots))

    pw = prev.clone().requires_grad_(True)
    params = list(gen.G0.parameters())
    want = torch.autograd.grad(loss(gen.G0(lab, pw, mask), lambda t: t), [pw] + params)

    def run(sh):
        m = copy.deepcopy(gen.G0)
        sync_batch_norm(m, sh.group)
        pl = sh.local(prev).clone().requires_grad_(True)
        with halo.sharded(sh):
            out = m(sh.local(lab), halo.gather_width(pl, sh), sh.local(mask))
        return torch.autograd.grad(loss(out, lambda t: halo.gather_width(t, sh)),
                                   [pl] + list(m.parameters()))

    got = on_shards(n, w, run, h)
    _close(torch.cat([g[0] for g in got], -1), want[0])
    scale = max(float(g.abs().max()) for g in want[1:])
    for i, wp in enumerate(want[1:]):
        _close(sum(g[1 + i] for g in got), wp, scale)


@pytest.mark.parametrize("n,scales,w", _cases({"2-2": (2, 2, 64), "4-1": (4, 1, 64)},
                                               [(4, 2, 40), (8, 2, 32)]))
def test_a_clip_with_bptt_on_shards_equals_the_whole(n, scales, w):
    """generate_clip(train=True) over 4 frames, BPTT across 3, remat on:
    the shards' frames bit for bit with the unsharded generator's, and
    their parameter gradients summed against its. No norm, so that every
    sum runs in one order (the norms' are held above): what is left is
    the model axis's exchanges, gathers and the warp's shared previous
    frames, forward, backward and in the remat's recompute (at 32 on 8 the
    coarsest trunk's 4 columns leave half the shards without one)."""
    h, t = 16, 4
    opt = Options(**dict(SCALE_OPT, norm="none", n_scales_spatial=scales, remat=True))
    gen = Vid2VidGenerator(opt)
    init_weights(gen, torch.Generator().manual_seed(0))
    gen.train()
    rng = np.random.default_rng(0)
    enc = gen.encode_input(torch.from_numpy(rng.integers(0, 4, (1, t + 2, h, w))))
    frames = torch.from_numpy(rng.uniform(-1, 1, (1, 2, 3, h, w)).astype(np.float32))
    cots = [torch.from_numpy(rng.standard_normal((1, t, c, h, w)).astype(np.float32))
            for c in (3, 3, 2, 1)]

    def clip(g, shard=None):
        outs, _ = g.generate_clip(enc, g.state_from_frames(frames), train=True, n_frames_bp=3,
                                  shard=shard)
        grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)),
                                    list(g.parameters()))
        return outs.fake.detach(), grads

    fake, want = clip(copy.deepcopy(gen))
    halo.reset_counts()
    got = on_shards(n, w, lambda sh: clip(copy.deepcopy(gen), sh), h)
    for f, _ in got:
        assert torch.equal(f, fake)
    scale = max(float(g.abs().max()) for g in want)
    for i, wp in enumerate(want):
        _close(sum(g[1][i] for g in got), wp, scale)
    # the halos' gradients went back, and the warp's previous frames' were
    # summed over the shards (BPTT reaches them)
    assert halo.COUNTS["exchanges_bwd"] > 0 and halo.COUNTS["reduces_bwd"] > 0


def test_remat_recomputes_under_the_shard():
    """Under remat the recompute in the backward runs each scale under the
    shard again, to its end: the exchanges after the backward are twice
    the forward's (the counts of both shards' threads)."""
    h, w = 16, 64
    opt = Options(**dict(SCALE_OPT, norm="none", remat=True))
    gen = Vid2VidGenerator(opt).train()
    init_weights(gen, torch.Generator().manual_seed(0))
    enc = gen.encode_input(torch.zeros(1, 3, h, w, dtype=torch.int64))
    frames = torch.zeros(1, 2, 3, h, w)
    forward = {}

    def run(sh):
        g = copy.deepcopy(gen)
        outs, _ = g.generate_clip(enc, g.state_from_frames(frames), train=True, shard=sh)
        sh.group.all_gather(torch.zeros(1))  # both forwards have run
        if sh.index == 0:
            forward.update(halo.COUNTS)
        sh.group.all_gather(torch.zeros(1))  # and no backward has yet
        torch.autograd.grad(outs.fake.sum(), list(g.parameters()))

    halo.reset_counts()
    on_shards(2, w, run, h)
    assert forward["exchanges"] > 0 and halo.COUNTS["exchanges"] == 2 * forward["exchanges"]
    assert 0 < halo.COUNTS["exchanges_bwd"] < forward["exchanges"]  # inputs with a gradient


def test_a_width_the_training_shards_cannot_hold_raises():
    """Trainer.shard on a mesh of data 1 x model 2 (set by hand here: no
    ranks): the shard of every width that splits over the ranks, its
    coarser levels unevenly (36: the trunk's 9 columns split 4 / 5), and
    ValueError naming training for one that does not (the JAX Trainer's
    device_put refuses it: halo.check_geometry)."""
    from vid2vid_tpu_torch.parallel.mesh import Mesh
    from vid2vid_tpu_torch.train.loop import Trainer

    trainer = Trainer(Options(**{**tp.CONFIG, **SMALL}), device="cpu")
    trainer.mesh = Mesh(1, 2, rank=1, world=2)
    sh = trainer.shard(64, 32)
    assert (sh.index, sh.n, sh.x0, sh.width, sh.total) == (1, 2, 32, 32, 64)
    sh = trainer.shard(36, 32)
    assert (sh.x0, sh.width) == (18, 18) and sh.at(2).bounds(1) == (4, 9)
    for width in (35, 7):  # not a multiple of 2
        with pytest.raises(ValueError, match=f"training on the model axis: width {width}"):
            trainer.shard(width, 32)


# ---------------------------------------------------------------- ranks


# the uneven training case: 32 x 36 on model 2, 1 scale, 2 downsamples (the
# trunk's 9 columns split 4 / 5)
UNEVEN_W = 36


def _clip(batch: int, seed: int = 11, w: int = tp.W):
    rng = np.random.default_rng(seed)
    n_total = 2 * tp.N_LOAD + tp.TG - 1
    labels = rng.integers(0, tp.LABEL_NC, (batch, n_total, tp.H, w)).astype(np.int32)
    real = rng.uniform(-1, 1, (batch, n_total, 3, tp.H, w)).astype(np.float32)
    return labels, real


def _jax_model_trainer(w: int = tp.W):
    """The JAX Trainer at batch 1 on --n_devices 2 for frames tp.H x w: its
    mesh is data 1 x model 2 (GSPMD shards the width, padding the uneven
    levels); its state from weights drawn with numpy on jax.eval_shape's
    trees (tests/test_torch_parallel.py::_draw), the same at every w."""
    trainer = JaxTrainer(JaxOptions(**{**tp.CONFIG, **SMALL, "batchSize": 1, "n_devices": 2,
                                       "fineSize": w}),
                         flow_fn=tp.jax_stub_flow)
    key, rng = jax.random.key(0), np.random.default_rng(5)
    gparams = _draw(jax.eval_shape(lambda k: trainer.gen.init(k, 1, tp.H, tp.W), key), rng)
    dparams = _draw(jax.eval_shape(lambda k: trainer.engine.init(k, tp.H, tp.W), key), rng)
    state, (trainer.g_tx, trainer.d_tx, trainer.dt_tx) = create_train_state(
        trainer.opt, gparams, dparams)
    state = jax.device_put(state, jax_replicated(trainer.mesh))
    trainer.g_step = make_g_step(trainer.gen, trainer.engine, trainer.opt, trainer.g_tx)
    trainer.d_step = make_d_step(trainer.engine, trainer.opt, trainer.d_tx)
    trainer.dt_step = make_dt_step(trainer.engine, trainer.opt, trainer.dt_tx)
    trainer.schedule.n_frames_bp = 1
    return trainer, state


@pytest.fixture(scope="module")
def runs():
    """The 2-rank launch (data 1 x model 2: the Trainer's chunks, the
    fault, the packages loaded, the chunks at the uneven width) and the
    4-rank launch (data 2 x model 2), with the port's one-process Trainer
    at batch 2, in threads while the JAX Trainer trains two chunks here on
    its model = 2 mesh at both widths."""
    with tp.torch_threads(1):
        trainer, state = _jax_model_trainer()
        assert dict(trainer.mesh.shape) == {"data": 1, "model": 2}
        opt = Options(**{**tp.CONFIG, **SMALL})
        weights = (generator_state_dict(state.gparams, opt),
                   loss_engine_state_dict(state.dparams, opt))
        model_cfg = {**tp.CONFIG, **SMALL, "batchSize": 1, "n_devices": 2}
        labels, real = _clip(1)
        kw = dict(n_load=tp.N_LOAD, weights=weights)
        labels_u, real_u = _clip(1, seed=13, w=UNEVEN_W)
        trainer_u, state_u = _jax_model_trainer(UNEVEN_W)
        kw_u = dict(kw, weights=(generator_state_dict(state_u.gparams, opt),
                                 loss_engine_state_dict(state_u.dparams, opt)))
        calls = [("train_chunks", (model_cfg, labels, real), kw),
                 ("train_chunks", (model_cfg, labels, real), dict(kw, fault="halo_grad_dropped")),
                 ("loaded_packages", (), {}),
                 ("train_chunks", ({**model_cfg, "fineSize": UNEVEN_W}, labels_u, real_u), kw_u)]
        both_cfg = {**tp.CONFIG, **SMALL, "batchSize": 2}
        labels2, real2 = _clip(2, seed=12)
        kw2 = dict(n_load=tp.N_LOAD, weights=weights, n_frames_bp=tp.N_LOAD)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            two = pool.submit(launch, functools.partial(torch_ranks.run_all, calls), 2,
                              devices=["cpu"] * 2, deadline_s=DEADLINE_S, threads=1)
            four = pool.submit(launch, functools.partial(torch_ranks.train_chunks, **kw2), 4,
                               args=({**both_cfg, "n_devices": 4}, labels2, real2),
                               devices=["cpu"] * 4, deadline_s=DEADLINE_S, threads=1)
            one = pool.submit(torch_ranks.train_chunks, both_cfg, labels2, real2, **kw2)
            want = _jax_chunks(trainer, state, labels, real)
            want_u = _jax_chunks(trainer_u, state_u, labels_u, real_u)
            return dict(want=want, want_uneven=want_u, two=two.result(), four=four.result(),
                        one=one.result())


def test_two_ranks_match_the_jax_model_mesh(runs):
    rank0, rank1 = (r[0] for r in runs["two"])
    assert tp.losses_within(rank0["losses"], runs["want"]) == []
    assert rank0["losses"] == rank1["losses"]
    assert len(rank0["digests"]) == 2 and rank0["digests"] == rank1["digests"]


def test_two_ranks_on_an_uneven_width_match_the_jax_model_mesh(runs):
    """32 x 36 on model 2: the port's trunk splits its 9 columns 4 / 5, as
    the JAX Trainer's GSPMD splits them with padding; every loss and grad
    norm within losses_within, but chunk 2's G grad norm within 10%: at
    this size Adam's first step turns f32 roundings of near-zero gradients
    into whole steps of lr, and that norm moved by 2.7% between the port's
    one process and the JAX mesh at this width, and by 6% between the
    port's two ranks and one process at width 40, whose levels split
    evenly (chunk 1's norms agree within 5e-4); the ranks' weights bit for
    bit alike."""
    rank0, rank1 = (r[3] for r in runs["two"])
    want = runs["want_uneven"]
    bad = tp.losses_within(rank0["losses"], want)
    assert [b for b in bad if not b.startswith("chunk 1 G_grad_norm")] == []
    got, ref = rank0["losses"][1]["G_grad_norm"], want[1]["G_grad_norm"]
    assert abs(got - ref) <= 0.1 * ref, (got, ref)
    assert rank0["losses"] == rank1["losses"] and rank0["digests"] == rank1["digests"]


def test_an_exchange_that_drops_the_halo_gradient_leaves_the_bounds(runs):
    got = runs["two"][0][1]["losses"]
    assert tp.losses_within(got, runs["want"]) != []


def test_data_2_x_model_2_matches_one_process(runs):
    ranks, one = runs["four"], runs["one"]
    assert tp.losses_within(ranks[0]["losses"], one["losses"]) == []
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    assert len(ranks[0]["digests"]) == 2


def test_a_model_axis_rank_imports_no_jax(runs):
    loaded = set(runs["two"][0][2])
    assert "vid2vid_tpu_torch" in loaded and not loaded & {"jax", "jaxlib", "flax",
                                                            "vid2vid_tpu"}
