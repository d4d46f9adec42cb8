"""The model axis for serving (vid2vid_tpu_torch/parallel/halo.py, the
width-sharded InferenceEngine and test CLI) on the CPU.

  - Halo units, one process, no ranks: a tensor split into 4 shards (one at
    each image edge), each shard's halo cut from the whole tensor, every
    layer that reads across columns (the conv7 and respair column-halo
    modes and their plain versions, the down conv, the transposed conv,
    the warp at an offset, the margin-sliced instance edges and pyramid)
    against the whole tensor's result: f32, bit for bit or within 1e-6,
    including halos as wide as the shard; widths the geometry cannot hold
    raise ValueError.
  - One launch of 2 gloo ranks (tests/torch_ranks.py::run_all):
    InferenceEngine(n_devices=2) through generate_clip_raw (6 frames), the
    step loop and generate_clip on the encoded clip, with and without
    instance edges and the fg branch,
    against the JAX package's one-device InferenceEngine on the same numpy
    inputs and the weights of its init (utils/from_jax.py) at atol 2e-5,
    JAX's own bound for its sharded engine (tests/test_parallel.py::
    TestMeshInference); the ranks' frames against each other bit for bit;
    three broken model axes (a halo from the neighbour's wrong side,
    reflection at the inner edges, the warp without its offset) out of that
    bound; and test_cli's rank, whose rank 0 writes the fake_B files of the
    one-process CLI, pixel for pixel.
The JAX engine compiles in this process while the ranks run.
"""

import concurrent.futures
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

import torch_ranks
from torch_parity import nhwc, torch_threads
from test_torch_cli import _flags as cli_flags
from test_torch_cli import _write_dataset as write_cli_dataset
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu_torch import test_cli
from vid2vid_tpu_torch.config import Options, parse_args
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.nn import layers as nn_layers
from vid2vid_tpu_torch.nn.blocks import ResnetBlock, conv_stem, down_block, up_block
from vid2vid_tpu_torch.nn.layers import DownConv2d, ReflectConv7, UpConvTranspose2d, init_weights
from vid2vid_tpu_torch.ops.conv7 import (
    conv7_halo,
    conv7_halo_plain,
    conv7_plain,
    conv7_reflect_plain,
)
from vid2vid_tpu_torch.ops.pool import build_pyramid_video
from vid2vid_tpu_torch.ops.respair import respair_halo, respair_halo_plain, respair_plain
from vid2vid_tpu_torch.ops.warp import warp_blend_at, warp_blend_plain
from vid2vid_tpu_torch.parallel import halo, launch
from vid2vid_tpu_torch.parallel.collectives import LocalGroup
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict

DEADLINE_S = 120.0
# tests/test_parallel.py::TestMeshInference's configuration, and its bound
MESH = dict(label_nc=4, use_instance=False, output_nc=3, ngf=8, n_downsample_G=2,
            n_blocks=2, n_blocks_local=2, n_scales_spatial=2, n_frames_G=3, norm="batch",
            fg=False, isTrain=False)
INST_FG = dict(MESH, use_instance=True, fg=True, fg_labels=(3,))
B, H, W, T = 1, 32, 64, 6  # T output frames: T + tG - 1 label frames
ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


# ----------------------------------------------------------------- halos

# (width, n) cases of the halo units by their old ids; the new ones: unequal
# shards (10 on 4), halos that span ranks (1-column shards) and shards with
# no columns (4 on 8)
def _cases(old: dict, new: list):
    return [pytest.param(*c, id=i) for i, c in old.items()] + [
        pytest.param(*c, id=f"{c[-2]}_on_{c[-1]}") for c in new]


UNEVEN = [(10, 4), (8, 8), (4, 8)]


def _strips(whole: torch.Tensor, shard: halo.WidthShard, left: int, right: int):
    """What `halo.exchange` gives `shard`, cut from the whole tensor
    reflect-padded (None on a side that is the image's edge)."""
    if not shard.width:
        return None, None
    p = max(left, right)
    xp = F.pad(whole, (p, p, 0, 0), mode="reflect")
    x0, x1 = shard.x0 + p, shard.x1 + p
    lstrip = None if shard.left_edge or not left else xp[..., x0 - left : x0]
    rstrip = None if shard.right_edge or not right else xp[..., x1 : x1 + right]
    return lstrip, rstrip


def _shards(width: int, n: int = 4, height: int = 1, group=None):
    return [halo.make_shard(i, n, width, group, height) for i in range(n)]


def on_shards(n: int, width: int, height: int, fn) -> list:
    """fn(shard) on each of n shards of frames width x height, each on a
    thread of one LocalGroup; their results in shard order."""
    group = LocalGroup(n)

    def member(i):
        with group.member(i):
            return fn(halo.make_shard(i, n, width, group, height))

    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        return [f.result() for f in [pool.submit(member, i) for i in range(n)]]


def _seeded(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# (C, H, W): the narrowest halos of the old cases are as wide as the shard
# (conv7: 3 of 3; respair: 2 of 2); the new ones reach across ranks and
# reflect into the other side's halo on 1-column edge shards
@pytest.mark.parametrize("width,n", _cases({"24": (24, 4), "12": (12, 4)}, UNEVEN))
def test_conv7_halo_mode_equals_the_whole_conv(width, n):
    x, wt, b = _seeded(1, 5, 9, width), _seeded(4, 5, 7, 7, seed=1) / 16, _seeded(4, seed=2)
    whole = conv7_reflect_plain(x, wt, b)
    for sh in _shards(width, n):
        if not sh.width:  # the layers launch nothing there (test_the_layers_...)
            assert _strips(x, sh, 3, 3) == (None, None)
            continue
        local = sh.local(x)
        padded = halo.padded_plain(x, sh, 3, 3, "reflect")
        got = conv7_plain(F.pad(padded, (0, 0, 3, 3), mode="reflect"), wt, b)
        assert torch.equal(got, sh.local(whole))
        lstrip, rstrip = _strips(x, sh, 3, 3)
        x_in, xoff = halo.attach(local, lstrip, rstrip)
        assert x_in.shape[-1] % halo.ALIGN == 0
        got = conv7_halo(x_in, wt, b, xoff, sh.width, sh.edges)  # the operator's CPU impl
        assert torch.equal(got, conv7_halo_plain(x_in, wt, b, xoff, sh.width, sh.edges))
        torch.testing.assert_close(got, sh.local(whole), atol=1e-6, rtol=0)


@pytest.mark.parametrize("width,n", _cases({"24": (24, 4), "8": (8, 4)}, UNEVEN))
def test_respair_halo_mode_equals_the_whole_block(width, n):
    c = 6
    x = _seeded(1, c, 7, width)
    k0, k1 = _seeded(c, c, 3, 3, seed=1) / 8, _seeded(c, c, 3, 3, seed=2) / 8
    ab0 = (_seeded(c, seed=3) * 0.1 + 1, _seeded(c, seed=4))
    ab1 = (_seeded(c, seed=5), _seeded(c, seed=6))
    whole = respair_plain(x, k0, ab0, k1, ab1)
    for sh in _shards(width, n):
        if not sh.width:
            continue
        local = sh.local(x).contiguous()
        x_in, xoff = halo.attach(local, *_strips(x, sh, 2, 2))
        got = respair_halo(local, x_in, xoff, sh.edges, k0, ab0, k1, ab1)
        assert torch.equal(got, respair_halo_plain(local, x_in, xoff, sh.edges, k0, ab0, k1, ab1))
        torch.testing.assert_close(got, sh.local(whole), atol=1e-6, rtol=0)


@pytest.mark.parametrize("width,n", _cases({"24": (24, 4), "8": (8, 4)}, UNEVEN))
def test_the_exchange_gives_each_shard_its_halo_columns(width, n):
    """halo.exchange on each shard, on threads of one LocalGroup (one
    all_gather each, every shard included): the strips of the whole
    tensor reflect-padded, from however many ranks they span."""
    x = _seeded(1, 3, 5, width)

    def run(sh):
        return [halo.exchange(sh.local(x).contiguous(), sh, left, right)
                for left, right in ((3, 3), (2, 2), (3, 0))]

    for sh, got in zip(_shards(width, n), on_shards(n, width, 5, run)):
        for (left, right), strips in zip(((3, 3), (2, 2), (3, 0)), got):
            for g, w in zip(strips, _strips(x, sh, left, right)):
                assert (g is None) == (w is None) and (g is None or torch.equal(g, w))


@pytest.mark.parametrize("width,n", _cases({"32": (32, 4), "16": (16, 4)},
                                           [(40, 4), (16, 8), (8, 8)]))
def test_the_layers_run_their_shards_in_one_process(width, n):
    """ReflectConv7, ResnetBlock, DownConv2d and UpConvTranspose2d in eval
    mode under halo.sharded, alone and as the stem, down and up blocks
    with their norms folded in (random running stats), each shard on a
    thread of one LocalGroup: each shard's output is the whole output's
    columns of its level (the down conv's a level below, the up conv's
    above, each split by its own rule: unequal, 1-column and empty
    shards), and each shard's call of a block folds its norm."""
    gen = torch.Generator().manual_seed(0)
    layers = [ReflectConv7(4, 3), ResnetBlock(4), DownConv2d(4, 3, 3, stride=2, padding=1),
              UpConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1),
              nn.Sequential(*conv_stem(4, 3, "batch")), nn.Sequential(*down_block(4, 3, "batch")),
              nn.Sequential(*up_block(4, 3, "instance"))]
    x = _seeded(1, 4, 6, width)
    for layer in layers:
        init_weights(layer, gen)
        for m in layer.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.InstanceNorm2d)):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
        layer.eval()
        with torch.no_grad():
            whole = layer(x)

        def run(sh):  # x is level 1 of frames 2 width x 12
            with torch.no_grad(), halo.sharded(sh):
                return layer(sh.level_of(x).local(x).contiguous())

        folded = nn_layers.folded_calls
        shards = on_shards(n, 2 * width, 12, run)
        assert nn_layers.folded_calls - folded == n * isinstance(layer, nn.Sequential)
        for sh, got in zip(_shards(2 * width, n, 12), shards):
            want = sh.level_of(whole).local(whole)
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0,
                                       msg=f"{type(layer).__name__} shard {sh.index}")


def test_a_train_mode_down_conv_on_two_shards_equals_the_whole():
    """A train-mode DownConv2d on two shards, each on a thread of one
    LocalGroup (its halo exchanged through halo.down_input,
    differentiable): the shards' outputs and input gradients are the whole
    conv's columns, their weight gradients sum to its
    (tests/test_torch_shard_train.py holds every train-mode layer so)."""
    layer = DownConv2d(2, 3, 3, stride=2, padding=1).train()
    init_weights(layer, torch.Generator().manual_seed(0))
    x = _seeded(1, 2, 4, 16)
    xw = x.clone().requires_grad_(True)
    y = layer(xw)
    cot = _seeded(*y.shape, seed=1)
    want = torch.autograd.grad((y * cot).sum(), [xw, layer.weight, layer.bias])

    def shard(sh):
        xl = sh.local(x).clone().requires_grad_(True)
        with halo.sharded(sh):
            yl = layer(xl)
        cols = slice(sh.x0 // 2, (sh.x0 + sh.width) // 2)
        assert torch.equal(yl, y.detach()[..., cols])
        return torch.autograd.grad((yl * cot[..., cols]).sum(), [xl, layer.weight, layer.bias])

    got = on_shards(2, 16, 4, shard)
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), want[0], rtol=0, atol=1e-7)
    for k in (1, 2):
        torch.testing.assert_close(got[0][k] + got[1][k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width,n", _cases({"64": (64, 4), "96": (96, 4)}, UNEVEN))
def test_the_warp_at_an_offset_equals_the_whole_warp(width, n):
    raw, prev = _seeded(1, 3, 8, width), _seeded(1, 3, 8, width, seed=1)
    flow = 6.0 * _seeded(1, 2, 8, width, seed=2)  # samples past the shards and the borders
    weight = torch.sigmoid(_seeded(1, 1, 8, width, seed=3))
    whole = warp_blend_plain(raw, prev, flow, weight)
    for sh in _shards(width, n):
        got = warp_blend_at(sh.local(raw).contiguous(), prev, sh.local(flow).contiguous(),
                            sh.local(weight).contiguous(), sh.x0)
        assert torch.equal(got, sh.local(whole))


@pytest.mark.parametrize("n_scales,width,n", _cases(
    {"2": (2, 64, 4), "3": (3, 64, 4)}, [(3, 40, 4), (2, 24, 8), (3, 32, 8)]))
def test_the_margin_sliced_encode_and_pyramid_equal_the_whole(n_scales, width, n):
    """Each shard encodes the columns of the raw labels and instance maps
    that its levels are pooled from (Vid2VidGenerator.encode_shard): its
    columns of the whole clip's encoded pyramid at every level, each level
    split by its own rule, bit for bit (the one-hot, the instance edges and
    the count_include_pad=False border divisors)."""
    opt = Options(**dict(INST_FG, n_scales_spatial=n_scales))
    gen = Vid2VidGenerator(opt)
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, 4, (1, 2, 8, width)).astype(np.int32))
    inst = torch.from_numpy(rng.integers(0, 3, (1, 2, 8, width)).astype(np.int32))
    whole = build_pyramid_video(gen.encode_input(labels, inst), n_scales)
    for sh in _shards(width, n, 8):
        got = gen.encode_shard(labels, inst, sh, "cpu")
        for level, (g, w) in enumerate(zip(got, whole)):
            assert torch.equal(g, sh.at(level).local(w)), (sh.index, level)


def test_a_width_the_shards_cannot_hold_raises():
    """The port refuses exactly the widths that the JAX engine's device_put
    refuses: those that are not a multiple of the ranks (InferenceEngine.
    shard on a mesh of data 1 x model n set by hand: no ranks)."""
    from vid2vid_tpu_torch.models.inference import InferenceEngine
    from vid2vid_tpu_torch.parallel.mesh import Mesh

    eng = InferenceEngine(Options(**MESH), device="cpu")
    for n in (4, 8):
        jeng = JaxEngine(JaxOptions(**MESH, n_devices=n))
        eng.mesh = Mesh(1, n, rank=1, world=n)
        for width in (32, 40, 64, 1440 // 8, 36, 42, 44):
            try:
                jeng._shard_width(np.zeros((1, 4, width), np.float32), 2)
                jax_ok = True
            except ValueError:
                jax_ok = False
            if jax_ok:
                sh = eng.shard(width, 4)
                assert (sh.x0, sh.x1) == (width // n, 2 * width // n)
            else:
                with pytest.raises(ValueError, match=f"width {width} on {n} ranks"):
                    eng.shard(width, 4)
            assert jax_ok == (width % n == 0), (width, n)


# ------------------------------------------------- uneven widths, threads

UNEVEN_SERVE = [(32, 40, 4), (32, 64, 8), (32, 32, 8)]
T_UNEVEN = 3


@pytest.fixture(scope="module")
def uneven():
    """At each (H, W, n) of UNEVEN_SERVE, on the JAX init's weights: the
    JAX one-device engine's generate_clip_raw, the port's unsharded
    InferenceEngine's, and the port's on n shards (each on a thread of one
    LocalGroup: the engine's sharded path, Vid2VidGenerator.
    generate_clip_streaming under the shard, with its collectives
    counted)."""
    from vid2vid_tpu_torch.models.inference import InferenceEngine

    jeng, params, weights = _jax_init(MESH)
    eng = InferenceEngine(Options(**MESH), device="cpu")
    eng.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    out = {}
    for h, w, n in UNEVEN_SERVE:
        rng = np.random.default_rng(h + w + n)
        labels = rng.integers(0, MESH["label_nc"], (B, T_UNEVEN + 2, h, w)).astype(np.int32)
        jouts, _ = jeng.generate_clip_raw(params, jnp.asarray(labels), None,
                                          jeng.initial_state(B, h, w))
        lab = torch.from_numpy(labels)
        one = eng.generate_clip_raw(lab, None, eng.initial_state(B, h, w))[0]
        halo.reset_counts()

        def run(sh):
            with torch.no_grad():
                return eng.compute_generator().generate_clip_streaming(
                    lab, None, eng.initial_state(B, h, w), shard=sh)[0]

        shards = on_shards(n, w, h, run)
        out[(h, w, n)] = dict(jax=np.asarray(jouts.fake), one=one, shards=shards,
                              counts=dict(halo.COUNTS))
    return out


@pytest.mark.parametrize("hwn", UNEVEN_SERVE, ids=[f"{h}x{w}_on_{n}" for h, w, n in UNEVEN_SERVE])
def test_uneven_widths_match_the_jax_engine(uneven, hwn):
    """The sharded engine at widths whose coarser levels split unevenly
    (40 on 4: the trunk's 5 columns; 64 on 8: 1 trunk column a shard under
    respair's 2-column halo; 32 on 8: 4 trunk columns, so some shards hold
    none) against the JAX one-device engine at atol 2e-5 and the port's
    unsharded engine at 1e-6; every shard's frames bit for bit alike."""
    r = uneven[hwn]
    first = r["shards"][0]
    assert first.fake.shape == (B, T_UNEVEN, 3) + hwn[:2]
    assert r["counts"]["exchanges"] > 0 and r["counts"]["gathers"] > 0
    for other in r["shards"][1:]:
        assert torch.equal(other.fake, first.fake) and torch.equal(other.raw, first.raw)
    assert _err(first.fake, r["jax"]) <= ATOL, _err(first.fake, r["jax"])
    torch.testing.assert_close(first.fake, r["one"].fake, rtol=0, atol=1e-6)
    torch.testing.assert_close(first.raw, r["one"].raw, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ ranks


def _clip(opt_kw: dict, seed: int):
    rng = np.random.default_rng(seed)
    n = T + opt_kw["n_frames_G"] - 1
    labels = rng.integers(0, opt_kw["label_nc"], (B, n, H, W)).astype(np.int32)
    inst = (rng.integers(0, 3, (B, n, H, W)).astype(np.int32)
            if opt_kw["use_instance"] else None)
    return labels, inst


def _jax_init(opt_kw: dict, seed: int = 0):
    """The JAX one-device engine, its variables drawn with numpy at the JAX
    package's initialisation (vid2vid_tpu/nn/layers.py: conv kernels N(0,
    0.02), norm scales 1 + N(0, 0.02), biases and running means 0, running
    variances 1) on the tree `jax.eval_shape` gives (a flax init of these
    nets takes ~15 s to compile), and the port's copy of them."""
    jeng = JaxEngine(JaxOptions(**opt_kw))
    rng = np.random.default_rng(seed)

    def draw(node, name=None):
        if hasattr(node, "items"):
            return {k: draw(v, k) for k, v in node.items()}
        if name.endswith("kernel"):  # the fused blocks' too (final_img_kernel, ...)
            return 0.02 * rng.standard_normal(node.shape, dtype=np.float32)
        if name.endswith("scale"):
            return 1.0 + 0.02 * rng.standard_normal(node.shape, dtype=np.float32)
        return np.full(node.shape, 1.0 if name == "var" else 0.0, np.float32)

    params = draw(jax.eval_shape(lambda k: jeng.gen.init(k, B, H, W), jax.random.key(0)))
    weights = {k: v.numpy() for k, v in generator_state_dict(params, Options(**opt_kw)).items()}
    return jeng, params, weights


def _jax_frames(jeng, params, opt_kw: dict, seed: int, steps: bool) -> dict:
    """generate_clip_raw's frames of the clip `seed` and, with `steps`, the
    step loop's over its windows."""
    labels, inst = _clip(opt_kw, seed)
    jinst = None if inst is None else jnp.asarray(inst)
    outs, _ = jeng.generate_clip_raw(params, jnp.asarray(labels), jinst,
                                     jeng.initial_state(B, H, W))
    out = {"fake": np.asarray(outs.fake), "raw": np.asarray(outs.raw)}
    if steps:
        tg, state, frames = opt_kw["n_frames_G"], jeng.initial_state(B, H, W), []
        for t in range(T):
            win = None if jinst is None else jinst[:, t : t + tg]
            frame, state = jeng.step(params, jnp.asarray(labels[:, t : t + tg]), win, state)
            frames.append(np.asarray(frame))
        out["steps"] = np.stack(frames, 1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 2 gloo ranks (every sharded serving case and the test
    CLI's rank) and the one-process CLI, in threads, while the JAX engine
    runs here (its init's weights go to the ranks first)."""
    root = tmp_path_factory.mktemp("shard_cli")
    write_cli_dataset(root / "data", np.random.default_rng(0))
    cases = {"mesh": (MESH, 1, None), "inst_fg": (INST_FG, 2, None)}
    cases.update({f: (MESH, 1, f) for f in torch_ranks.SHARD_FAULTS})
    with torch_threads(1):
        init = {"mesh": _jax_init(MESH), "inst_fg": _jax_init(INST_FG)}
        calls = [("shard_serve", ({**kw, "n_devices": 2}, init["inst_fg" if kw is INST_FG
                                                              else "mesh"][2],
                                  *_clip(kw, seed)), {"fault": fault})
                 for kw, seed, fault in cases.values()]
        cli_opt = parse_args(cli_flags(root, "sharded") + ["--n_devices", "2"], is_train=False,
                             save=False).replace(phase="test", nThreads=1, serial_batches=True,
                                                 no_flip=True, isTrain=False,
                                                 dataset_mode="test")
        calls.append(("test_cli_rank", (cli_opt,), {}))
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(launch, functools.partial(torch_ranks.run_all, calls), 2,
                                devices=["cpu"] * 2, deadline_s=DEADLINE_S, threads=1)
            cli_one = pool.submit(test_cli.main, cli_flags(root, "one"))
            ref = {"mesh": _jax_frames(*init["mesh"][:2], MESH, 1, steps=True),
                   "inst_fg": _jax_frames(*init["inst_fg"][:2], INST_FG, 2, steps=False)}
            results, cli_count = ranks.result(), cli_one.result()
    names = list(cases) + ["cli"]
    return {"ref": ref, "ranks": [dict(zip(names, r)) for r in results], "root": root,
            "cli_count": cli_count}


def _err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(nhwc(got) - want).max())


@pytest.mark.parametrize("case", ["mesh", "inst_fg"])
def test_two_ranks_match_the_jax_engine(runs, case):
    ref = runs["ref"][case]
    first, second = (r[case] for r in runs["ranks"])
    assert first["columns"] == (0, W // 2) and second["columns"] == (W // 2, W // 2)
    # the model axis ran: halos exchanged, every scale's frame gathered
    assert first["counts"]["exchanges"] > 0 and first["counts"]["gathers"] >= 2 * T
    for key in ("fake", "raw"):
        got = first["clip"][key]
        assert got.shape == (B, T, 3, H, W)
        assert torch.equal(got, second["clip"][key])
        assert _err(got, ref[key]) <= ATOL, (case, key, _err(got, ref[key]))
    for s, t in zip(first["state"], second["state"]):
        assert torch.equal(s, t)
    assert torch.equal(first["steps"], second["steps"])
    want_steps = ref.get("steps", ref["fake"])
    assert _err(first["steps"], want_steps) <= ATOL
    # generate_clip on the encoded clip: each rank its columns of it
    assert torch.equal(first["encoded"], second["encoded"])
    assert _err(first["encoded"], ref["fake"]) <= ATOL


@pytest.mark.parametrize("fault", torch_ranks.SHARD_FAULTS)
def test_a_broken_model_axis_leaves_the_bound(runs, fault):
    got = runs["ranks"][0][fault]["clip"]["fake"]
    assert _err(got, runs["ref"]["mesh"]["fake"]) > 10 * ATOL


def test_the_sharded_cli_writes_the_one_process_frames(runs):
    """test_cli --n_devices 2 --gpu_ids -1 (rank 0 writes) against the same
    CLI in one process: the same files, the same fake_B pixels."""
    root = runs["root"]
    assert [r["cli"] for r in runs["ranks"]] == [runs["cli_count"]] * 2
    assert runs["cli_count"] > 0
    sharded = root / "sharded" / "cli" / "test_latest"
    one = root / "one" / "cli" / "test_latest"
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(sharded)) and any("fake_B" in n for n in names)
    for name in names:
        a = np.asarray(Image.open(one / name))
        b = np.asarray(Image.open(sharded / name))
        assert np.array_equal(a, b), name
