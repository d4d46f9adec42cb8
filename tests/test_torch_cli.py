"""The port's streaming CLI against the JAX package's, end to end on CPU.

A tiny label2city-style test set (label maps + instance maps, two
sequences) goes through `vid2vid_tpu.test_cli` and
`vid2vid_tpu_torch.test_cli` with the same flags and the same weights
(random, saved as an orbax snapshot for the JAX CLI and as the
reference's per-scale .pth files for the port); they write the same files,
the same label maps and frames that agree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import randomize, torch_threads
from vid2vid_tpu import test_cli as jax_cli
from vid2vid_tpu.config import parse_args
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu.train.checkpoints import save_params
from vid2vid_tpu_torch import test_cli
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict

H, W, N_FRAMES = 64, 128, 4


def _write_dataset(root, rng):
    for seq in ("seq0", "seq1"):
        for sub, hi in (("test_A", 4), ("test_inst", 3)):
            os.makedirs(os.path.join(root, sub, seq))
            for k in range(N_FRAMES):
                arr = rng.integers(0, hi, (H // 8, W // 8)).astype(np.uint8)
                arr = np.kron(arr, np.ones((8, 8), np.uint8))  # blocky maps
                Image.fromarray(arr).save(os.path.join(root, sub, seq, f"f{k:02d}.png"))


def _flags(tmp_path, results):
    return [
        "--dataroot", str(tmp_path / "data"), "--label_nc", "4", "--use_instance",
        "--fg", "--fg_labels", "3", "--ngf", "8", "--n_downsample_G", "2",
        "--n_blocks", "3", "--n_blocks_local", "1", "--n_scales_spatial", "2",
        "--loadSize", str(W), "--name", "cli", "--checkpoints_dir",
        str(tmp_path / "ck"), "--results_dir", str(tmp_path / results),
        "--gpu_ids", "-1",
    ]


def test_cli_matches_jax_cli(tmp_path):
    _write_dataset(tmp_path / "data", np.random.default_rng(0))
    # the same weights for both: an orbax snapshot for the JAX CLI, the
    # reference's per-scale latest_net_G{s}.pth files for the port
    opt = parse_args(_flags(tmp_path, "unused"), is_train=False, save=False)
    rng = np.random.default_rng(1)
    params = {k: randomize(v, rng)
              for k, v in JaxEngine(opt).init(jax.random.key(0), 1, H, W).items()}
    save_params(opt, params, "G_latest")
    sd = generator_state_dict(params, opt)
    os.makedirs(tmp_path / "ck" / "cli", exist_ok=True)
    for s in range(2):
        torch.save({k[3:]: v for k, v in sd.items() if k.startswith(f"G{s}.")},
                   tmp_path / "ck" / "cli" / f"latest_net_G{s}.pth")

    jax_cli.main(_flags(tmp_path, "res_jax"))
    count = test_cli.main(_flags(tmp_path, "res_port"))
    assert count == 2 * (N_FRAMES - 2)  # per sequence: tG-1 warm-up frames

    jdir = tmp_path / "res_jax" / "cli" / "test_latest"
    pdir = tmp_path / "res_port" / "cli" / "test_latest"
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert names == [f"f{k:02d}_{label}.jpg" for k in (2, 3) for label in ("fake_B", "real_A")]
    for name in names:
        if name.endswith("_real_A.jpg"):  # the same label colours, the same file
            assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
            continue
        got = np.asarray(Image.open(pdir / name), np.int16)
        want = np.asarray(Image.open(jdir / name), np.int16)
        assert got.shape == (H, W, 3) and want.std() > 1.0  # not a flat frame
        # the frames agree to 2e-3 in [-1, 1] (a quarter of an 8-bit level);
        # JPEG coding of frames that round differently moves a few levels
        assert np.abs(got - want).max() <= 8, name
        assert np.abs(got - want).mean() <= 0.5, name


def test_cli_use_single_g(tmp_path, capsys, monkeypatch):
    """--use_single_G --gpu_ids -1 on a tiny city test set: every sequence
    is seeded by the label2city 512 registry's GlobalGenerator (ngf 64, 3
    downsamples) with reference-named weights from
    <checkpoints_dir>/label2city_single/G_512.pth; the CLI's frames are the
    engine's, driven directly with the same weights (to f32 rounding: the
    process's first convolutions may sum in another order), and the first
    ones differ from a zero-seeded run's."""
    from vid2vid_tpu_torch.data.test_stream import TestTemporalStream
    from vid2vid_tpu_torch.models.inference import InferenceEngine
    from vid2vid_tpu_torch.nn.layers import init_weights
    from vid2vid_tpu_torch.nn.pix2pixhd import GlobalGenerator

    _write_dataset(tmp_path / "city", np.random.default_rng(0))
    flags = _flags(tmp_path, "res") + ["--use_single_G", "--resize_or_crop", "none"]
    flags[flags.index("--dataroot") + 1] = str(tmp_path / "city")
    flags[flags.index("--loadSize") + 1] = "512"  # the registry's key
    net = GlobalGenerator(4, ngf=64, n_downsampling=3)
    init_weights(net, torch.Generator().manual_seed(7))
    os.makedirs(tmp_path / "ck" / "label2city_single")
    torch.save(net.state_dict(), tmp_path / "ck" / "label2city_single" / "G_512.pth")

    written = {}
    save = test_cli.save_frame
    monkeypatch.setattr(test_cli, "save_frame", lambda v, d, o, item, frame: written.setdefault(
        item["path"], frame) is not None and save(v, d, o, item, frame))
    assert test_cli.main(flags) == 2 * (N_FRAMES - 2)
    warned = capsys.readouterr().out
    assert "net_G*.pth" in warned and "single-image checkpoint" not in warned
    assert len(written) == 4  # two per sequence; both write f02 / f03_*.jpg
    assert {p.name for p in (tmp_path / "res" / "cli" / "test_latest").iterdir()} == {
        "f02_fake_B.jpg", "f03_fake_B.jpg", "f02_real_A.jpg", "f03_real_A.jpg"}

    opt = parse_args(flags, is_train=False, save=False)
    eng = InferenceEngine(opt, device="cpu")
    test_cli.load_weights(opt, eng)
    test_cli.load_single_g(opt, eng)
    torch.testing.assert_close(eng.single_g.state_dict(), net.state_dict())
    frames = {item["path"]: f for item, f in
              test_cli.stream_frames(opt, eng, TestTemporalStream(opt))}
    zero = {item["path"]: f for item, f in test_cli.stream_frames(
        opt.replace(use_single_G=False), eng, TestTemporalStream(opt))}
    assert sorted(frames) == sorted(written)
    for path, frame in frames.items():
        torch.testing.assert_close(written[path], frame, atol=1e-5, rtol=0)
    first = [p for p in frames if p.endswith("f02.png")]
    assert len(first) == 2
    for p in first:
        assert float((frames[p] - zero[p]).abs().max()) > 1e-3


def test_stream_resets_state_per_sequence():
    """Each sequence re-seeds the state and warms up tG-1 frames again."""
    from vid2vid_tpu.config import Options
    from vid2vid_tpu_torch.models.inference import InferenceEngine

    opt = Options(label_nc=3, ngf=4, n_downsample_G=1, n_blocks=1,
                  n_scales_spatial=1, isTrain=False, how_many=100)
    eng = InferenceEngine(opt, device="cpu")
    seeds = []
    orig = eng.initial_state
    eng.initial_state = lambda *a, **k: seeds.append(a) or orig(*a, **k)
    items = [
        {"A": np.zeros((8, 8), np.int32), "change_seq": k in (0, 3), "path": f"{k}"}
        for k in range(7)
    ]
    out = [item["path"] for item, _ in test_cli.stream_frames(opt, eng, items)]
    assert out == ["2", "5", "6"]
    assert len(seeds) == 2


def test_unported_dataset_modes_raise(tmp_path):
    """The face and pose modes are ported: the CLI opens their test streams
    (which look for their own directories)."""
    for mode, missing in (("face", "test_keypoints"), ("pose", "test_img")):
        with pytest.raises(FileNotFoundError, match=missing):
            test_cli.main(["--dataset_mode", mode, "--checkpoints_dir", str(tmp_path),
                           "--dataroot", str(tmp_path), "--gpu_ids", "-1", "--label_nc", "0",
                           "--ngf", "8", "--n_downsample_G", "1", "--n_blocks", "1"])


def _drawn(init, rng, *args):
    """Variables of the tree `init` would return, drawn with numpy without
    compiling it (kernels N(0, 0.02), norm scales 1, the rest 0), then
    randomized (biases, running stats): for nets whose parameters are all
    flax Conv / norm leaves (the single-image nets)."""
    shapes = jax.eval_shape(init, jax.random.key(0), *args)

    def walk(node, name=None):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "kernel":
            return 0.02 * rng.standard_normal(node.shape).astype(np.float32)
        return np.full(node.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)

    return randomize(walk(shapes), rng)


def _same_weights(tmp_path, flags, h, w):
    """The generator's random weights as the JAX CLI's orbax snapshot and as
    the port's latest_net_G0.pth."""
    opt = parse_args(flags, is_train=False, save=False)
    rng = np.random.default_rng(1)
    params = {k: randomize(v, rng)
              for k, v in JaxEngine(opt).init(jax.random.key(0), 1, h, w).items()}
    save_params(opt, params, "G_latest")
    os.makedirs(tmp_path / "ck" / "cli", exist_ok=True)
    sd = generator_state_dict(params, opt)
    torch.save({k[3:]: v for k, v in sd.items() if k.startswith("G0.")},
               tmp_path / "ck" / "cli" / "latest_net_G0.pth")
    return opt


def _face_registry(tmp_path, opt, hw):
    """The edge2face registry's GlobalWithFeatures and Encoder at their
    published widths with random weights, and a clusters file: orbax trees
    under edge2face_single/state/ for the JAX CLI, .pth files and
    features.npy beside them for the port."""
    import orbax.checkpoint as ocp

    from vid2vid_tpu_torch.utils.from_jax import encoder_state_dict, single_g_state_dict

    jeng = JaxEngine(opt)
    jeng.build_single_g()
    rng = np.random.default_rng(2)
    gparams = _drawn(jeng._single_g.init, rng, jnp.zeros((1, hw, hw, 15)),
                     jnp.zeros((1, hw, hw, 16)))
    eparams = _drawn(jeng._encoder.init, rng, jnp.zeros((1, hw, hw, 3)),
                     jnp.zeros((1, hw, hw), jnp.int32))
    root = tmp_path / "ck" / "edge2face_single"
    for name, tree in (("G", gparams), ("E", eparams)):
        ocp.PyTreeCheckpointer().save(str(root / "state" / name), tree, force=True)
    torch.save(single_g_state_dict(gparams, "global_with_features", n_downsampling=3,
                                   n_blocks=9), root / "G.pth")
    torch.save(encoder_state_dict(eparams, n_downsampling=4), root / "E.pth")
    clusters = {p: rng.standard_normal((4, 17)).astype(np.float32) for p in range(1, 7)}
    for path in (root / "features.npy", root / "state" / "features.npy"):
        np.save(path, clusters, allow_pickle=True)


def _compare_results(tmp_path, n_frames):
    jdir = tmp_path / "res_jax" / "cli" / "test_latest"
    pdir = tmp_path / "res_port" / "cli" / "test_latest"
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert len(names) == 2 * n_frames
    for name in names:
        if name.endswith("_real_A.jpg"):  # the same conditioning, the same file
            assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name
            continue
        got = np.asarray(Image.open(pdir / name), np.int16)
        want = np.asarray(Image.open(jdir / name), np.int16)
        assert want.std() > 1.0  # not a flat frame
        # the bounds of test_cli_matches_jax_cli
        assert np.abs(got - want).max() <= 8, name
        assert np.abs(got - want).mean() <= 0.5, name


@pytest.mark.parametrize("mode", ["face", "pose"])
def test_cli_face_and_pose_modes_match_jax_cli(tmp_path, mode):
    """--dataset_mode face with --use_single_G (the edge2face registry at
    its published widths seeds each sequence from the stream's real frames
    and part maps) and --dataset_mode pose with --no_first_img, on trees of
    two sequences, against the JAX CLI: the same files, real_A byte for
    byte, the frames within test_cli_matches_jax_cli's bounds."""
    from test_torch_face_pose_data import write_face_tree, write_pose_tree

    root = tmp_path / mode  # the registry is chosen by "face" in the dataroot
    if mode == "face":  # 26-wide faces: 64-square crops, which loadSize 64 keeps
        write_face_tree(str(root), phase="test", n_frames=4, hw=(96, 96), width=26)
        extra, (h, w) = ["--input_nc", "15", "--loadSize", "64", "--use_single_G"], (64, 64)
    else:  # scaleHeight keeps 96x128; the central crop gives 96x64
        write_pose_tree(str(root), phase="test", n_frames=4, hw=(96, 128))
        extra, (h, w) = ["--input_nc", "6", "--resize_or_crop", "scaleHeight", "--loadSize",
                         "96", "--no_first_img"], (96, 64)

    def flags(results):
        return ["--dataroot", str(root), "--dataset_mode", mode, "--label_nc", "0",
                "--ngf", "8", "--n_downsample_G", "2", "--n_blocks", "2",
                "--n_scales_spatial", "1", "--name", "cli", "--checkpoints_dir",
                str(tmp_path / "ck"), "--results_dir", str(tmp_path / results),
                "--gpu_ids", "-1", *extra]

    opt = _same_weights(tmp_path, flags("unused"), h, w)
    if mode == "face":
        _face_registry(tmp_path, opt, h)
    jax_cli.main(flags("res_jax"))
    with torch_threads(1):
        assert test_cli.main(flags("res_port")) == 2 * (4 - 2)
    _compare_results(tmp_path, 2 * (4 - 2))
