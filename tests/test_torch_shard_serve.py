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

import torch_ranks
from torch_parity import nhwc, torch_threads
from test_torch_cli import _flags as cli_flags
from test_torch_cli import _write_dataset as write_cli_dataset
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu_torch import test_cli
from vid2vid_tpu_torch.config import Options, parse_args
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
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


def _strips(whole: torch.Tensor, shard: halo.WidthShard, left: int, right: int):
    """What `halo.exchange` gives `shard`, cut from the whole tensor."""
    x0, w = shard.x0, shard.width
    lstrip = None if shard.left_edge or not left else whole[..., x0 - left : x0]
    rstrip = None if shard.right_edge or not right else whole[..., x0 + w : x0 + w + right]
    return lstrip, rstrip


def _shards(width: int, n: int = 4):
    return [halo.make_shard(i, n, width) for i in range(n)]


def _whole_exchange(monkeypatch, whole_of):
    """halo.exchange answered from the whole tensors (by local tensor id),
    so that a layer runs its shard path in one process."""
    def exchange(x, shard, left, right):
        assert max(left, right) <= x.shape[-1]
        return _strips(whole_of[id(x)], shard, left, right)

    monkeypatch.setattr(halo, "exchange", exchange)


def _seeded(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# (C, H, W) with 4 shards: the widest have 6 columns; the narrowest halos
# are as wide as the shard (conv7: 3 of 3; respair: 2 of 2)
@pytest.mark.parametrize("width", [24, 12])
def test_conv7_halo_mode_equals_the_whole_conv(width):
    x, wt, b = _seeded(1, 5, 9, width), _seeded(4, 5, 7, 7, seed=1) / 16, _seeded(4, seed=2)
    whole = conv7_reflect_plain(x, wt, b)
    for sh in _shards(width):
        local = sh.local(x)
        lstrip, rstrip = _strips(x, sh, 3, 3)
        padded = halo.with_halo_plain(local, lstrip, rstrip, sh, "reflect", (3, 3))
        got = conv7_plain(F.pad(padded, (0, 0, 3, 3), mode="reflect"), wt, b)
        assert torch.equal(got, sh.local(whole))
        x_in, xoff = halo.attach(local, lstrip, rstrip)
        assert x_in.shape[-1] % halo.ALIGN == 0
        got = conv7_halo(x_in, wt, b, xoff, sh.width, sh.edges)  # the operator's CPU impl
        assert torch.equal(got, conv7_halo_plain(x_in, wt, b, xoff, sh.width, sh.edges))
        torch.testing.assert_close(got, sh.local(whole), atol=1e-6, rtol=0)


@pytest.mark.parametrize("width", [24, 8])
def test_respair_halo_mode_equals_the_whole_block(width):
    c = 6
    x = _seeded(1, c, 7, width)
    k0, k1 = _seeded(c, c, 3, 3, seed=1) / 8, _seeded(c, c, 3, 3, seed=2) / 8
    ab0 = (_seeded(c, seed=3) * 0.1 + 1, _seeded(c, seed=4))
    ab1 = (_seeded(c, seed=5), _seeded(c, seed=6))
    whole = respair_plain(x, k0, ab0, k1, ab1)
    for sh in _shards(width):
        local = sh.local(x).contiguous()
        x_in, xoff = halo.attach(local, *_strips(x, sh, 2, 2))
        got = respair_halo(local, x_in, xoff, sh.edges, k0, ab0, k1, ab1)
        assert torch.equal(got, respair_halo_plain(local, x_in, xoff, sh.edges, k0, ab0, k1, ab1))
        torch.testing.assert_close(got, sh.local(whole), atol=1e-6, rtol=0)


@pytest.mark.parametrize("width", [32, 16])
def test_the_layers_run_their_shards_in_one_process(width, monkeypatch):
    """ReflectConv7, ResnetBlock, DownConv2d and UpConvTranspose2d in eval
    mode under halo.sharded, their exchanges answered from the whole
    input: each shard's output is the whole output's columns."""
    gen = torch.Generator().manual_seed(0)
    layers = [ReflectConv7(4, 3), ResnetBlock(4), DownConv2d(4, 3, 3, stride=2, padding=1),
              UpConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1)]
    x = _seeded(1, 4, 6, width)
    for layer in layers:
        init_weights(layer, gen)
        layer.eval()
        with torch.no_grad():
            whole = layer(x)
            whole_of = {}
            _whole_exchange(monkeypatch, whole_of)
            for sh in _shards(width):
                local = sh.local(x).contiguous()
                whole_of[id(local)] = x
                with halo.sharded(sh):
                    got = layer(local)
                f = got.shape[-1] / local.shape[-1]
                want = whole[..., int(sh.x0 * f) : int((sh.x0 + sh.width) * f)]
                torch.testing.assert_close(got, want, atol=1e-6, rtol=0,
                                           msg=f"{type(layer).__name__} shard {sh.index}")


def test_a_train_mode_down_conv_on_two_shards_equals_the_whole():
    """A train-mode DownConv2d on two shards, each on a thread of one
    LocalGroup (its halo exchanged through halo.padded, differentiable):
    the shards' outputs and input gradients are the whole conv's columns,
    their weight gradients sum to its (tests/test_torch_shard_train.py
    holds every train-mode layer so)."""
    layer = DownConv2d(2, 3, 3, stride=2, padding=1).train()
    init_weights(layer, torch.Generator().manual_seed(0))
    x = _seeded(1, 2, 4, 16)
    xw = x.clone().requires_grad_(True)
    y = layer(xw)
    cot = _seeded(*y.shape, seed=1)
    want = torch.autograd.grad((y * cot).sum(), [xw, layer.weight, layer.bias])
    group = LocalGroup(2)

    def shard(i):
        sh = halo.make_shard(i, 2, 16, group)
        xl = sh.local(x).clone().requires_grad_(True)
        with group.member(i), halo.sharded(sh):
            yl = layer(xl)
            cols = slice(sh.x0 // 2, (sh.x0 + sh.width) // 2)
            assert torch.equal(yl, y.detach()[..., cols])
            return torch.autograd.grad((yl * cot[..., cols]).sum(), [xl, layer.weight, layer.bias])

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got = list(pool.map(shard, range(2)))
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), want[0], rtol=0, atol=1e-7)
    for k in (1, 2):
        torch.testing.assert_close(got[0][k] + got[1][k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width", [64, 96])
def test_the_warp_at_an_offset_equals_the_whole_warp(width):
    raw, prev = _seeded(1, 3, 8, width), _seeded(1, 3, 8, width, seed=1)
    flow = 6.0 * _seeded(1, 2, 8, width, seed=2)  # samples past the shards and the borders
    weight = torch.sigmoid(_seeded(1, 1, 8, width, seed=3))
    whole = warp_blend_plain(raw, prev, flow, weight)
    for sh in _shards(width):
        got = warp_blend_at(sh.local(raw).contiguous(), prev, sh.local(flow).contiguous(),
                            sh.local(weight).contiguous(), sh.x0)
        assert torch.equal(got, sh.local(whole))


@pytest.mark.parametrize("n_scales", [2, 3])
def test_the_margin_sliced_encode_and_pyramid_equal_the_whole(n_scales):
    """Each shard encodes its columns of the raw labels and instance maps
    with the margin and pools them (Vid2VidGenerator.encode_shard): its
    columns of the whole clip's encoded pyramid, bit for bit (the one-hot,
    the instance edges and the count_include_pad=False border divisors)."""
    opt = Options(**dict(INST_FG, n_scales_spatial=n_scales))
    gen = Vid2VidGenerator(opt)
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, 4, (1, 2, 8, 64)).astype(np.int32))
    inst = torch.from_numpy(rng.integers(0, 3, (1, 2, 8, 64)).astype(np.int32))
    whole = build_pyramid_video(gen.encode_input(labels, inst), n_scales)
    for sh in _shards(64):
        got = gen.encode_shard(labels, inst, sh, "cpu")
        for level, (g, w) in enumerate(zip(got, whole)):
            assert torch.equal(g, sh.at(level).local(w)), (sh.index, level)


def test_a_width_the_shards_cannot_hold_raises():
    halo.check_geometry(64, 2, 2, 4)
    for width, n in ((72, 2), (48, 4), (16, 2)):  # not a multiple of 16; too narrow
        with pytest.raises(ValueError, match=f"width {width} on {n} ranks"):
            halo.check_geometry(width, n, 2, 4)
    with pytest.raises(ValueError, match="wider than the shard"):
        halo.exchange(torch.zeros(1, 1, 2, 2), halo.make_shard(0, 2, 4), 3, 3)


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
        import time; t00 = time.time()
        init = {"mesh": _jax_init(MESH), "inst_fg": _jax_init(INST_FG)}
        print("init", time.time() - t00)
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
            import time; t0 = time.time()
            ref = {"mesh": _jax_frames(*init["mesh"][:2], MESH, 1, steps=True),
                   "inst_fg": _jax_frames(*init["inst_fg"][:2], INST_FG, 2, steps=False)}
            print("jax", time.time() - t0)
            results, cli_count = ranks.result(), cli_one.result()
            print("ranks", time.time() - t0)
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
