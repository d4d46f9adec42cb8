"""The port's standalone flow-net tools (vid2vid_tpu_torch.models.flownet2:
flow_io, datasets, losses, harness, main_cli) against the JAX package's, on
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import init_like, nchw, randomize
from vid2vid_tpu.models.flownet2 import datasets as jax_datasets
from vid2vid_tpu.models.flownet2 import flow_io as jax_flow_io
from vid2vid_tpu.models.flownet2 import losses as jax_losses
from vid2vid_tpu.models.flownet2.harness import FlowHarness as JaxFlowHarness
from vid2vid_tpu.models.flownet2.nets import FlowNetC as JaxFlowNetC
from vid2vid_tpu.utils.torch_import import apply_mapping
from vid2vid_tpu_torch.models.flownet2 import datasets, flow_io, losses
from vid2vid_tpu_torch.models.flownet2.harness import FlowHarness
from vid2vid_tpu_torch.models.flownet2.main_cli import main
from vid2vid_tpu_torch.models.flownet2.nets import FlowNetC, init_flownet_weights
from vid2vid_tpu_torch.utils.from_jax import flownet_mapping, flownet_state_dict

DIV_FLOW = 0.05


def test_flo_round_trip_matches_jax_bytes(tmp_path, rng):
    flow = rng.standard_normal((12, 16, 2)).astype(np.float32)
    ours, theirs = tmp_path / "port.flo", tmp_path / "jax.flo"
    flow_io.write_flo(str(ours), flow)
    jax_flow_io.write_flo(str(theirs), flow)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(flow_io.read_flo(str(theirs)), flow)
    (tmp_path / "bad.flo").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        flow_io.read_flo(str(tmp_path / "bad.flo"))


class _Pairs:
    """Two (pair (2, H, W, 3), flow (H, W, 2)) samples from numpy."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        pair = r.random((2, 64, 128, 3)).astype(np.float32)
        return pair, r.standard_normal((64, 128, 2)).astype(np.float32)


def test_harness_matches_jax(tmp_path):
    """infer_to_flo and validate on the same FlowNetC weights: the flows
    agree within the nets' bound 2e-4 divided by div_flow."""
    shapes = jax.eval_shape(
        JaxFlowNetC(train_outputs=True).init, jax.random.key(0),
        jnp.zeros((1, 64, 64, 6)),
    )
    rng = np.random.default_rng(0)
    variables = randomize(init_like(shapes, rng), rng)
    net = FlowNetC(train_outputs=True)
    net.load_state_dict(flownet_state_dict(variables, "FlowNetC"), strict=True)
    port = FlowHarness(net, div_flow=DIV_FLOW, device="cpu")
    ref = JaxFlowHarness(JaxFlowNetC(train_outputs=True), div_flow=DIV_FLOW)

    port.infer_to_flo(_Pairs(), str(tmp_path / "port"))
    ref.infer_to_flo(variables, _Pairs(), str(tmp_path / "jax"))
    for i in range(2):
        got = flow_io.read_flo(str(tmp_path / "port" / f"{i:06d}.flo"))
        want = flow_io.read_flo(str(tmp_path / "jax" / f"{i:06d}.flo"))
        assert got.shape == (64, 128, 2)
        assert np.abs(got).max() > 0.1  # a flow, not zeros
        np.testing.assert_allclose(got, want, atol=2e-4 / DIV_FLOW)
    assert port.validate(_Pairs()) == pytest.approx(
        ref.validate(variables, _Pairs()), abs=2e-4 / DIV_FLOW
    )


def _image(path, rng, h=70, w=135):
    """A random RGB image; 70x135 center-crops to 64x128."""
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8), "RGB").save(str(path))


def _flo(path, rng, h=70, w=135):
    path.parent.mkdir(parents=True, exist_ok=True)
    flow_io.write_flo(str(path), rng.standard_normal((h, w, 2)).astype(np.float32))


def _frames(folder, n=3):
    r = np.random.default_rng(0)
    for i in range(n):
        _image(folder / f"{i:04d}.png", r, 64, 128)


def test_cli_inference_writes_finite_flo(tmp_path, capsys):
    """The CLI's .flo files equal the JAX harness's on the same seeded
    FlowNetC weights, carried to JAX, and the same frames."""
    _frames(tmp_path / "frames")
    flows = {}
    for name in ("a", "b"):
        rc = main([
            "--inference", "--model", "FlowNetC",
            "--inference_dataset", "ImagesFromFolder",
            "--inference_dataset_root", str(tmp_path / "frames"),
            "--save", str(tmp_path / "work"), "--name", name, "--seed", "3",
            "--device", "cpu",
        ])
        assert rc == 0
        assert "wrote 2 .flo files" in capsys.readouterr().out
        out = tmp_path / "work" / f"{name}_inference"
        assert sorted(p.name for p in out.iterdir()) == ["000000.flo", "000001.flo"]
        flows[name] = [flow_io.read_flo(str(p)) for p in sorted(out.iterdir())]
        for flow in flows[name]:
            assert flow.shape == (64, 128, 2) and np.isfinite(flow).all()
            assert np.abs(flow).max() > 0.1
    # the weights come from --seed alone
    for a, b in zip(flows["a"], flows["b"]):
        np.testing.assert_array_equal(a, b)

    net = FlowNetC(train_outputs=True)
    init_flownet_weights(net, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = apply_mapping(sd, flownet_mapping("FlowNetC"))
    ref = JaxFlowHarness(JaxFlowNetC(train_outputs=True), div_flow=DIV_FLOW)
    ref.infer_to_flo(variables, jax_datasets.ImagesFromFolder(str(tmp_path / "frames")),
                     str(tmp_path / "jax"))
    for i, got in enumerate(flows["a"]):
        want = flow_io.read_flo(str(tmp_path / "jax" / f"{i:06d}.flo"))
        np.testing.assert_allclose(got, want, atol=2e-4 / DIV_FLOW)


@pytest.fixture(scope="module")
def dataset_tree(tmp_path_factory):
    """One root that holds a tiny tree of every dataset format: two Sintel
    scenes (clean and final), two FlyingChairs triples, FlyingThings clean
    and final with left/right views, two ChairsSDHom triples and three
    top-level frames; images are 70x135, so each sample is center-cropped."""
    root = tmp_path_factory.mktemp("flow_datasets")
    rng = np.random.default_rng(0)
    for scene in ("alley", "market"):
        for i in (1, 2):
            _flo(root / "flow" / scene / f"frame_{i:04d}.flo", rng)
        for dstype in ("clean", "final"):
            for i in (1, 2, 3):
                _image(root / dstype / scene / f"frame_{i:04d}.png", rng)
    for i in (1, 2):
        _flo(root / f"{i:05d}_flow.flo", rng)
        for j in (1, 2):
            _image(root / f"{i:05d}_img{j}.ppm", rng)
    for side in ("left", "right"):
        _flo(root / "optical_flow_flo_format/TRAIN/A/0000/into_future" / side / "0006.flo", rng)
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            for i in (6, 7):
                _image(root / dstype / "TRAIN/A/0000" / side / f"{i:04d}.png", rng)
    for i in (1, 2):
        _flo(root / "train/flow" / f"{i:05d}.flo", rng)
        for t in ("t0", "t1"):
            _image(root / "train" / t / f"{i:05d}.png", rng)
    for i in range(3):
        _image(root / f"{i:04d}.png", rng)
    return root


@pytest.mark.parametrize(
    "name,n",
    [
        ("MpiSintelClean", 4), ("MpiSintelFinal", 4), ("FlyingChairs", 2),
        ("FlyingThingsClean", 2), ("FlyingThingsFinal", 2), ("ChairsSDHom", 2),
        ("ImagesFromFolder", 2),
    ],
)
def test_dataset_matches_jax(dataset_tree, name, n):
    port = getattr(datasets, name)(str(dataset_tree))
    ref = getattr(jax_datasets, name)(str(dataset_tree))
    assert len(port) == len(ref) == n
    assert port.samples == ref.samples
    for i in range(n):
        (pair, flow), (want_pair, want_flow) = port[i], ref[i]
        assert pair.shape == (2, 64, 128, 3) and flow.shape == (64, 128, 2)
        assert pair.dtype == flow.dtype == np.float32
        np.testing.assert_array_equal(pair, want_pair)
        np.testing.assert_array_equal(flow, want_flow)


def _pyramid(rng):
    """FlowNetS's five training flows for a 64x64 target, finest first."""
    return [rng.standard_normal((2, s, s, 2)).astype(np.float32) for s in (16, 8, 4, 2, 1)]


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_multiscale_flow_loss_matches_jax(rng, norm):
    pyramid = _pyramid(rng)
    target = (3.0 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32)
    loss, err = losses.multiscale_flow_loss([nchw(f) for f in pyramid], nchw(target),
                                            norm=norm)
    want_loss, want_err = jax_losses.multiscale_flow_loss(
        [jnp.asarray(f) for f in pyramid], jnp.asarray(target), norm=norm)
    assert float(loss) > 0.1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(err), float(want_err), rtol=1e-5)


@pytest.mark.parametrize("fn", ["epe", "l1_loss", "l2_loss"])
def test_flow_loss_matches_jax(rng, fn):
    pred, target = (rng.standard_normal((2, 9, 13, 2)).astype(np.float32) for _ in range(2))
    got = getattr(losses, fn)(nchw(pred), nchw(target))
    want = getattr(jax_losses, fn)(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _chairs_tree(root, n=2, hw=(64, 64)):
    """A FlyingChairs tree of n (img1, img2, flow) triples."""
    r = np.random.default_rng(0)
    for i in range(n):
        for tag in ("img1", "img2"):
            _image(root / f"{i:05d}_{tag}.ppm", r, *hw)
        flow_io.write_flo(str(root / f"{i:05d}_flow.flo"), np.ones(hw + (2,), np.float32))
    return root


@pytest.mark.parametrize(
    "argv",
    [
        ["--model", "FlowNetS"],
        ["--inference", "--resume", "best"],
    ],
    ids=["train", "resume"],
)
def test_training_mode_is_not_ported(tmp_path, capsys, argv):
    """Both modes once raised NotImplementedError (training was not
    ported); now each runs. Training (no --inference) fits FlowNetS for an
    epoch on a FlyingChairs tree and writes the checkpoint and best files;
    --resume best restores the best file of such a run before inference
    writes its .flo files."""
    data = _chairs_tree(tmp_path / "chairs")
    common = ["--save", str(tmp_path / "work"), "--device", "cpu", "--name", "run"]
    fit = ["--training_dataset_root", str(data), "--validation_dataset", "FlyingChairs",
           "--validation_dataset_root", str(data), "--total_epochs", "1"]
    resume = "--resume" in argv
    if resume:  # a best file to resume from, then inference on the tree's frames
        assert main(["--model", "FlowNetS"] + fit + common) == 0
        capsys.readouterr()
        extra = ["--model", "FlowNetS", "--inference_dataset_root", str(data),
                 "--inference_dataset_ext", "ppm"]
    else:
        extra = fit
    assert main(argv + extra + common) == 0
    out = capsys.readouterr().out
    if resume:
        assert "resumed best (epoch 1, best EPE" in out
        assert len(list((tmp_path / "work" / "run_inference").iterdir())) == 3
    else:
        assert "best val EPE:" in out
        for tag in ("checkpoint", "model_best"):
            assert (tmp_path / "work" / f"run_{tag}.pth.tar").is_file()
