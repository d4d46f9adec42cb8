"""Training's model axis (vid2vid_tpu_torch/parallel/halo.py: the
width-sharded generator, discriminators, VGG and losses in Trainer) on the
CPU.

  - One process, no ranks: N = 2 and 4 shards of a frame, each on a thread
    of a parallel.collectives.LocalGroup (the collectives answered in
    memory), against the whole tensor in f32:
      - halo.padded, forward and backward, against halo.padded_plain;
      - every train-mode layer that reads across columns or normalises
        over them (the reflection pads ahead of the 3x3 and 7x7 convs, the
        down and transposed up convs, batch norm over the group, instance
        norm over the model axis, the residual block): forward, input
        gradient and the shards' weight gradients summed;
      - the loss side's modules (D's 4x4 convs at stride 2 and 1, VGG's
        3x3 conv, the 2x2 max and average pools and the 3x3/s2 average
        pool, MultiscaleDiscriminator with num_D and n_layers_D 2 or 3 in
        train mode, Vgg19Features) on 2, 4 and 8 shards, unequal and empty
        ones too: every output the whole's columns, input gradients and
        summed weight gradients the whole's (f32, 1e-5);
      - the losses' shares (share_mean, gan_loss in its three modes,
        feature matching, masked_l1) and vgg_loss, whose pooling test reads
        the whole width: the shards' values summed and their gradients;
      - warp_blend_at's plain backward at each shard's offset against
        warp_blend's on the whole frame (d_prev summed over the shards),
        and flow_warp_at with its backward against flow_warp's;
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
    netD's finest layer sees the shard's columns; three faults leave those
    bounds: the exchanges' backward dropping the halos' gradient, D's
    gradients averaged over the model axis (not summed), each rank's
    losses its own columns' means; the training slice's configuration
    (VGG, two D copies) on the same ranks against the JAX model mesh and
    the port's one process; the face D with sparse_D against the port's
    one process, and a face box per rank leaving its bounds; the Trainer
    with a seeded FlowEstimator at 64 x 128 (FlowNet2 and its confidence
    on the ranks' columns: flow_fn(..., shard=)) against the port's one
    process.
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
from vid2vid_tpu_torch import losses
from vid2vid_tpu_torch.nn.discriminator import MultiscaleDiscriminator
from vid2vid_tpu_torch.nn.layers import ShardConv2d
from vid2vid_tpu_torch.nn.vgg import Vgg19Features
from vid2vid_tpu_torch.ops.pool import avg_pool_2x2, avg_pool_3x3s2, max_pool_2x2
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_at,
    flow_warp_at_bwd,
    flow_warp_backward_plain,
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


# ---------------------------------------- the loss side's modules, one process

# (factory of a module or pool, widths): each runs as fn(x, shard) (None:
# whole) inside `_Flat`; 2, 4 and 8 shards at even and uneven widths, and
# shards with no columns (4 on 8, and every narrow layer of D and VGG)
_WIDTHS = [(2, WIDTH), (4, WIDTH), (4, 10), (8, 8), (8, 4)]
_VGG_WIDTHS = [(2, WIDTH), (4, 26), (8, 16), (8, 20)]


class _Flat(torch.nn.Module):
    """fn(x, shard) (a module of the loss side, registered as this one's
    child, or a pool) with its outputs as one flat list: D's per-copy
    lists of features, VGG's taps, a layer's output."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x, shard=None):
        out = self.fn(x, shard)
        return [t for o in (out if isinstance(out, list) else [out])
                for t in (o if isinstance(o, list) else [o])]


LOSS_SIDE = {
    "d_conv_stride2": (lambda: ShardConv2d(4, 3, 4, 2, 2), _WIDTHS),
    "d_conv_stride1": (lambda: ShardConv2d(4, 3, 4, 1, 2), _WIDTHS),
    "vgg_conv": (lambda: ShardConv2d(4, 3, 3, padding=1), _WIDTHS),
    "max_pool_2x2": (lambda: max_pool_2x2, _WIDTHS),
    "avg_pool_3x3s2": (lambda: avg_pool_3x3s2, _WIDTHS),
    "avg_pool_2x2": (lambda: avg_pool_2x2, _WIDTHS),
    "discriminator_2x2": (lambda: MultiscaleDiscriminator(4, 8, 2, "batch", 2, True), _WIDTHS),
    "discriminator_3x3": (lambda: MultiscaleDiscriminator(4, 8, 3, "batch", 3, True), _WIDTHS),
    "vgg19": (Vgg19Features, _VGG_WIDTHS),
}


@pytest.mark.parametrize("name,n,width", [
    pytest.param(name, n, w, id=f"{name}-{w}_on_{n}")
    for name, (_, widths) in LOSS_SIDE.items() for n, w in widths])
def test_a_loss_side_module_on_shards_equals_the_whole(name, n, width):
    """Each shard runs the module (a 4x4 conv of D at stride 2 and 1, VGG's
    3x3 conv, the pools, netD with num_D and n_layers_D 2 or 3 in train
    mode with batch norm over the shards' group, VGG19) on its columns of
    (2, 4, H, width) or, for VGG, (1, 3, 16, width) frames: every output
    is the whole output's columns of its width (D's W / 2 + 1 and W + 1,
    each split by the same rule; shards with none), f32 within rtol 1e-5
    and atol 1e-5; the shards' input gradients side by side are the whole
    input's and their weight gradients sum to the whole module's (atol
    1e-5 of the largest weight gradient)."""
    module = _Flat(LOSS_SIDE[name][0]())
    init_weights(module, torch.Generator().manual_seed(0))
    module.train()
    update_running_stats(module, False)
    params = [p for p in module.parameters() if p.requires_grad]
    x = _seeded(1, 3, 16, width) if name == "vgg19" else _seeded(2, 4, 12, width)
    xw = x.clone().requires_grad_(True)
    ys = module(xw)
    cots = [_seeded(*y.shape, seed=3 + i) for i, y in enumerate(ys)]
    want = torch.autograd.grad(sum((y * c).sum() for y, c in zip(ys, cots)), [xw] + params)

    def run(sh):
        m = copy.deepcopy(module)
        sync_batch_norm(m, sh.group)
        xl = sh.local(x).clone().requires_grad_(True)
        got, loss = m(xl, sh), 0.0
        assert len(got) == len(ys)
        for yl, y, c in zip(got, ys, cots):
            cols = slice(*sh.of_width(y.shape[-1]).bounds(sh.index))
            assert yl.shape == y[..., cols].shape
            torch.testing.assert_close(yl, y.detach()[..., cols], rtol=1e-5, atol=1e-5)
            loss = loss + (yl * c[..., cols]).sum()
        return torch.autograd.grad(loss, [xl] + [p for p in m.parameters() if p.requires_grad])

    out = on_shards(n, width, run)
    _close(torch.cat([o[0] for o in out], -1), want[0])
    scale = max(float(g.abs().max()) for g in want[1:]) if params else None
    for i, w in enumerate(want[1:]):
        _close(sum(o[1 + i] for o in out), w, scale)


@pytest.mark.parametrize("n,width", _WIDTHS, ids=[f"{w}_on_{n}" for n, w in _WIDTHS])
def test_the_losses_global_means_on_shards_equal_the_whole(n, width):
    """share_mean, gan_loss (ls, original, hinge), feature_matching_loss
    and masked_l1 on each shard's columns given the whole widths: the
    shards' shares sum to the whole tensors' values, f32 within rtol 1e-5
    and atol 1e-6, and the shards' gradients side by side are the whole's
    (1 / the global count at each element, no collective)."""
    pred = [[_seeded(2, 3, 5, width, seed=i + 2 * s) for i in range(2)] for s in range(2)]
    real = [[_seeded(2, 3, 5, width, seed=9 + i + 2 * s) for i in range(2)] for s in range(2)]
    mask = torch.sigmoid(_seeded(2, 1, 5, width, seed=20))

    def all_losses(p, r, m, total):
        widths = None if total is None else [[total] * 2] * 2
        out = [losses.share_mean(p[0][0], total), losses.masked_l1(p[0][0], r[0][0], m, total),
               losses.feature_matching_loss(p, r, 2, 1, 10.0, widths)]
        for mode in ("ls", "original", "hinge"):
            out += [losses.gan_loss(p, True, mode, widths=widths),
                    losses.gan_loss(p, False, mode, for_discriminator=False, widths=widths)]
        return out

    leaves = [t.clone().requires_grad_(True) for scale in pred for t in scale]
    want = all_losses([leaves[:2], leaves[2:]], real, mask, None)
    want_grads = [torch.autograd.grad(v, leaves, allow_unused=True) for v in want]

    def run(sh):
        local = [sh.local(t).clone().requires_grad_(True) for scale in pred for t in scale]
        rl = [[sh.local(t) for t in scale] for scale in real]
        got = all_losses([local[:2], local[2:]], rl, sh.local(mask), width)
        return [v.detach() for v in got], [torch.autograd.grad(v, local, allow_unused=True)
                                           for v in got]

    out = on_shards(n, width, run)
    for k, w in enumerate(want):
        torch.testing.assert_close(sum(o[0][k] for o in out), w.detach(), rtol=1e-5, atol=1e-6)
    out = [o[1] for o in out]
    for k, grads in enumerate(want_grads):
        for j, w in enumerate(grads):
            got = [o[k][j] for o in out]
            if w is None:
                assert all(g is None for g in got)
                continue
            torch.testing.assert_close(torch.cat(got, -1), w, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("max_width", [1024, 24], ids=["full", "pooled"])
@pytest.mark.parametrize("n", [2, 4])
def test_vgg_loss_on_shards_reads_the_whole_width(n, max_width):
    """vgg_loss on each shard's columns (its share) summed over the shards
    equals the whole frames' within f32 rtol 1e-5: at max_width 24 the
    whole 32-column frames take one 2x2 pool, which a shard's 16 or 8
    columns alone would skip; the gradients of x side by side are the
    whole's."""
    vgg = Vgg19Features()
    init_weights(vgg, torch.Generator().manual_seed(0))
    x, y = _seeded(1, 3, 32, WIDTH), _seeded(1, 3, 32, WIDTH, seed=1)
    xw = x.clone().requires_grad_(True)
    want = losses.vgg_loss(vgg, xw, y, max_width)
    (gx,) = torch.autograd.grad(want, [xw])

    def run(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        got = losses.vgg_loss(vgg, xl, sh.local(y), max_width, shard=sh)
        return got.detach(), torch.autograd.grad(got, [xl])[0]

    out = on_shards(n, WIDTH, run, 32)
    torch.testing.assert_close(sum(o[0] for o in out), want.detach(), rtol=1e-5, atol=1e-7)
    _close(torch.cat([o[1] for o in out], -1), gx)


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


@pytest.mark.parametrize("n,width", _cases({"2": (2, 48), "4": (4, 48)}, [(4, 10), (8, 4)]))
def test_the_offset_warp_equals_the_whole(n, width):
    """flow_warp_at on each shard's columns (x0 > 0 on all but the first,
    flows of several pixels that sample across the shards and past the
    borders) is flow_warp's columns on the whole frame bit for bit;
    flow_warp_at_bwd gives d_flow at the shard's columns bit for bit with
    the whole backward's, and the shards' d_image (each over the whole
    frame) sum to the whole's (atol 1e-5); the autograd of flow_warp_at
    gives the same; at x0 = 0 with the whole width it is flow_warp's
    backward bit for bit; with no columns, d_image is zeros."""
    _, image, flow, _, g = _warp_inputs(width)
    want = flow_warp(image, flow)
    want_bwd = flow_warp_backward_plain(image, flow, g)
    at0 = flow_warp_at_bwd(image, flow, g, 0)
    assert torch.equal(flow_warp_at(image, flow, 0), want)
    assert all(torch.equal(a, b) for a, b in zip(at0, want_bwd))
    dimage = torch.zeros_like(image)
    for sh in (halo.make_shard(i, n, width) for i in range(n)):
        fl, gl = sh.local(flow).contiguous(), sh.local(g).contiguous()
        assert torch.equal(flow_warp_at(image, fl, sh.x0), sh.local(want))
        got = flow_warp_at_bwd(image, fl, gl, sh.x0)
        assert torch.equal(got[1], sh.local(want_bwd[1]))
        dimage += got[0]
        leaves = [image.clone().requires_grad_(True), fl.clone().requires_grad_(True)]
        auto = torch.autograd.grad((flow_warp_at(*leaves, sh.x0) * gl).sum(), leaves)
        assert all(torch.equal(a, b) for a, b in zip(auto, got))
    torch.testing.assert_close(dimage, want_bwd[0], rtol=0, atol=1e-5)


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


# the FlowNet2 case: one chunk of frames FLOW_HW (FlowNet2 takes multiples
# of 64: 64 columns a rank, 1 at its coarsest level)
FLOW_HW = (64, 128)


def _flow_clip(seed: int = 17):
    rng = np.random.default_rng(seed)
    h, w = FLOW_HW
    labels = rng.integers(0, tp.LABEL_NC, (1, tp.N_LOAD + tp.TG - 1, h, w)).astype(np.int32)
    real = rng.uniform(-1, 1, (1, tp.N_LOAD + tp.TG - 1, 3, h, w)).astype(np.float32)
    return labels, real


def _jax_model_trainer(w: int = tp.W, cut: dict = SMALL):
    """The JAX Trainer of tp.CONFIG with `cut` at batch 1 on --n_devices 2
    for frames tp.H x w: its mesh is data 1 x model 2 (GSPMD shards the
    width, padding the uneven levels); its state from weights drawn with
    numpy on jax.eval_shape's trees (tests/test_torch_parallel.py::_draw),
    the same at every w."""
    trainer = JaxTrainer(JaxOptions(**{**tp.CONFIG, **cut, "batchSize": 1, "n_devices": 2,
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
    faults, the packages loaded, the chunks at the uneven width, the
    training slice's configuration, the face D with sparse_D, FlowNet2 as
    the flow) and the
    4-rank launch (data 2 x model 2), with the port's one-process Trainer
    at batch 2, at the training slice's configuration and with the face D,
    in threads while the JAX Trainer trains two chunks here on its model =
    2 mesh at both widths and at the training slice's configuration."""
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
        full_cfg = {**tp.CONFIG, "batchSize": 1}
        trainer_f, state_f = _jax_model_trainer(cut={})
        opt_f = Options(**tp.CONFIG)
        kw_f = dict(n_load=tp.N_LOAD, weights=(generator_state_dict(state_f.gparams, opt_f),
                                               loss_engine_state_dict(state_f.dparams, opt_f)))
        face_cfg = {**tp.CONFIG, **SMALL, "batchSize": 1, "add_face_disc": True,
                    "sparse_D": True}
        flow_cfg = {**tp.CONFIG, **SMALL, "batchSize": 1, "fineSize": FLOW_HW[1]}
        flow_clip, flow_kw = _flow_clip(), dict(n_load=tp.N_LOAD, flow="flownet2")
        calls = [("train_chunks", (model_cfg, labels, real), kw),
                 ("train_chunks", (model_cfg, labels, real), dict(kw, fault="halo_grad_dropped")),
                 ("loaded_packages", (), {}),
                 ("train_chunks", ({**model_cfg, "fineSize": UNEVEN_W}, labels_u, real_u), kw_u),
                 ("train_chunks", (model_cfg, labels, real), dict(kw, fault="d_grads_averaged")),
                 ("train_chunks", (model_cfg, labels, real), dict(kw, fault="local_loss_means")),
                 ("train_chunks", ({**full_cfg, "n_devices": 2}, labels, real), kw_f),
                 ("train_chunks", ({**face_cfg, "n_devices": 2}, labels, real),
                  dict(n_load=tp.N_LOAD)),
                 ("train_chunks", ({**face_cfg, "n_devices": 2}, labels, real),
                  dict(n_load=tp.N_LOAD, fault="face_box_per_rank")),
                 ("train_chunks", ({**flow_cfg, "n_devices": 2}, *flow_clip), flow_kw)]
        both_cfg = {**tp.CONFIG, **SMALL, "batchSize": 2}
        labels2, real2 = _clip(2, seed=12)
        kw2 = dict(n_load=tp.N_LOAD, weights=weights, n_frames_bp=tp.N_LOAD)
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            two = pool.submit(launch, functools.partial(torch_ranks.run_all, calls), 2,
                              devices=["cpu"] * 2, deadline_s=DEADLINE_S, threads=1)
            four = pool.submit(launch, functools.partial(torch_ranks.train_chunks, **kw2), 4,
                               args=({**both_cfg, "n_devices": 4}, labels2, real2),
                               devices=["cpu"] * 4, deadline_s=DEADLINE_S, threads=1)
            one = pool.submit(torch_ranks.train_chunks, both_cfg, labels2, real2, **kw2)
            full_one = pool.submit(torch_ranks.train_chunks, full_cfg, labels, real, **kw_f)
            face_one = pool.submit(torch_ranks.train_chunks, face_cfg, labels, real,
                                   n_load=tp.N_LOAD)
            flow_one = pool.submit(torch_ranks.train_chunks, flow_cfg, *flow_clip, **flow_kw)
            want = _jax_chunks(trainer, state, labels, real)
            want_u = _jax_chunks(trainer_u, state_u, labels_u, real_u)
            want_f = _jax_chunks(trainer_f, state_f, labels, real)
            return dict(want=want, want_uneven=want_u, want_full=want_f, two=two.result(),
                        four=four.result(), one=one.result(), full_one=full_one.result(),
                        face_one=face_one.result(), flow_one=flow_one.result())


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


def test_the_discriminators_run_on_the_shards_columns(runs):
    """netD's finest layer saw the shard's columns on the model axis (32 of
    64; 18 of the uneven 36), the whole width in one process."""
    two = runs["two"]
    assert [r[0]["d_widths"] for r in two] == [[tp.W // 2]] * 2
    assert [r[3]["d_widths"] for r in two] == [[UNEVEN_W // 2]] * 2
    assert [r[6]["d_widths"] for r in two] == [[tp.W // 2]] * 2
    assert runs["full_one"]["d_widths"] == [tp.W]


def test_d_gradients_averaged_over_the_model_axis_leave_the_bounds(runs):
    """netD's and netD_T's gradients averaged over the model axis instead
    of summed: each rank's is its columns' share, so the grad norms fall by
    half (Adam would hide the scale in the weights: the norms show it)."""
    bad = tp.losses_within(runs["two"][0][4]["losses"], runs["want"])
    assert any(b.startswith("chunk 0 D_grad_norm") for b in bad)
    assert any(b.startswith("chunk 0 D_T_grad_norm0") for b in bad)


def test_local_loss_means_leave_the_bounds(runs):
    """Each rank's losses as the means of its own columns: the losses read
    off the whole frame's, and their gradients count each column twice."""
    bad = tp.losses_within(runs["two"][0][5]["losses"], runs["want"])
    assert any(b.startswith("chunk 0 D_real") for b in bad)
    assert any(b.startswith("chunk 0 G_grad_norm") for b in bad)


def test_two_ranks_with_vgg_and_two_d_copies_match_one_process(runs):
    """The training slice's own configuration (VGG, num_D 2, n_layers_D 2,
    two residual blocks) on model 2 from the JAX model mesh's weights: VGG
    and both D copies on the shards' columns, within losses_within of the
    port's one process, the ranks bit for bit."""
    rank0, rank1 = (r[6] for r in runs["two"])
    assert tp.losses_within(rank0["losses"], runs["full_one"]["losses"]) == []
    assert rank0["losses"][0]["G_VGG"] > 0
    assert rank0["losses"] == rank1["losses"] and rank0["digests"] == rank1["digests"]


def test_two_ranks_with_vgg_and_two_d_copies_match_the_jax_model_mesh(runs):
    """The same run within losses_within of the JAX Trainer on its model =
    2 mesh at that configuration (GSPMD partitions VGG, both D copies and
    the losses over the width), from the same weights."""
    assert tp.losses_within(runs["two"][0][6]["losses"], runs["want_full"]) == []


FACE_KEYS = ("G_f_GAN", "G_f_GAN_Feat", "D_f_real", "D_f_fake")


def test_two_ranks_with_the_face_d_and_sparse_d_match_one_process(runs):
    """--add_face_disc and --sparse_D on model 2: the face box over both
    ranks' columns, the crop gathered whole, netD_f whole on each rank with
    a half share of its losses, the sparse temporal buffers at the rank's
    columns; every loss and the face losses within losses_within of the
    port's one process from the same seeded weights, the face found (its
    losses nonzero), the ranks bit for bit."""
    rank0, rank1 = (r[7] for r in runs["two"])
    assert tp.losses_within(rank0["losses"], runs["face_one"]["losses"], FACE_KEYS) == []
    assert all(c["D_f_real"] > 0 and c["G_f_GAN"] > 0 for c in rank0["losses"])
    assert rank0["losses"] == rank1["losses"] and rank0["digests"] == rank1["digests"]


def test_a_face_box_per_rank_on_the_model_axis_leaves_the_bounds(runs):
    """Each rank's face box from its own columns alone: the ranks crop
    different windows, and the face losses leave the bounds."""
    bad = tp.losses_within(runs["two"][0][8]["losses"], runs["face_one"]["losses"], FACE_KEYS)
    assert any(b.startswith("chunk 0 D_f_") or b.startswith("chunk 0 G_f_") for b in bad)


def test_two_ranks_with_flownet2_on_their_columns_match_one_process(runs):
    """A seeded FlowEstimator as the Trainer's flow_fn on model 2 at 64 x
    128: each rank's reference flow and confidence come back at its 64
    columns (FlowNet2 sharded, flow_fn(..., shard=)), the one process's at
    128, and chunk 1's losses and grad norms are within losses_within of
    the port's one process, the ranks bit for bit."""
    rank0, rank1 = (r[9] for r in runs["two"])
    one = runs["flow_one"]
    assert rank0["flow_widths"] == rank1["flow_widths"] == [FLOW_HW[1] // 2]
    assert one["flow_widths"] == [FLOW_HW[1]]
    assert tp.losses_within(rank0["losses"], one["losses"]) == []
    assert rank0["losses"][0]["F_Flow"] > 0
    assert rank0["losses"] == rank1["losses"] and rank0["digests"] == rank1["digests"]


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
