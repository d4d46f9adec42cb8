"""The port's image converters, visualizer and gallery against the JAX
package's, the training CLI's visuals dump, and a training CLI run that
imports no PIL (--no_html)."""

import sys
import time

import numpy as np
import pytest
import torch

from vid2vid_tpu.utils import images as jax_images
from vid2vid_tpu.utils.visualizer import Visualizer as JaxVisualizer
from vid2vid_tpu_torch import train_cli
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data.synthetic import moving_square_clip
from vid2vid_tpu_torch.train.loop import Trainer
from vid2vid_tpu_torch.utils import images
from vid2vid_tpu_torch.utils.visualizer import Visualizer

TINY = dict(label_nc=4, ngf=8, ndf=8, n_downsample_G=2, n_blocks=1, n_scales_spatial=1,
            n_frames_G=3, n_frames_D=3, n_scales_temporal=1, num_D=1, n_layers_D=2,
            n_frames_total=4, max_frames_per_gpu=2, no_vgg=True, norm="batch", no_flow=True,
            gpu_ids=(), niter=1, niter_decay=0, name="tiny")


@pytest.mark.parametrize("name,args", [
    ("to_image", lambda r: (r.uniform(-1.5, 1.5, (9, 11, 3)).astype(np.float32),)),
    ("to_image", lambda r: (r.uniform(-1, 1, (9, 11, 1)).astype(np.float32),)),
    ("to_image", lambda r: (r.uniform(-1, 1, (9, 11)),)),
    ("label_to_color", lambda r: (r.integers(0, 40, (9, 11)), 35)),
    ("label_to_color", lambda r: (r.integers(0, 40, (9, 11)), 8)),
    ("label_to_color", lambda r: (r.random((9, 11, 6)), 6)),
    ("generic_colormap", lambda r: (300,)),
    ("flow_to_color", lambda r: (3 * r.standard_normal((9, 11, 2)).astype(np.float32),)),
    ("flow_to_color", lambda r: (np.zeros((4, 5, 2), np.float32),)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_converters_match_jax(name, args, rng):
    args = args(rng)
    got, want = getattr(images, name)(*args), getattr(jax_images, name)(*args)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_logs_and_gallery_match_jax(tmp_path, monkeypatch):
    """loss_log.txt, scalars.tsv (--tf_log without a TensorBoard backend),
    the gallery's images and index.html, and save_images' files, for the
    same calls."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(time, "strftime", lambda fmt: "a fixed time")
    rng = np.random.default_rng(0)
    visuals = {"real": rng.integers(0, 255, (8, 12, 3), dtype=np.uint8),
               "fake": rng.integers(0, 255, (8, 12, 3), dtype=np.uint8), "none": None}
    out = {}
    for side, cls in (("jax", JaxVisualizer), ("port", Visualizer)):
        opt = Options(checkpoints_dir=str(tmp_path / side), name="vis", tf_log=True)
        v = cls(opt)
        assert v.tb is None
        for epoch, step in ((1, 3), (2, 7)):
            v.print_current_errors(epoch, step, {"G_GAN": 1.5, "D_real": 0.0, "x": 2e-4}, 0.25)
            v.plot_current_errors({"G_GAN": 1.5, "D_real": 0.0}, step)
            v.display_current_results(visuals, epoch, step)
        v.vis_print("End of epoch 2")
        saved = v.save_images(str(tmp_path / side / "res"), visuals, "seq/frame_001.png")
        root = tmp_path / side / "vis"
        out[side] = (
            [(root / f).read_text() for f in ("loss_log.txt", "scalars.tsv", "web/index.html")],
            sorted(p.name for p in (root / "web" / "images").iterdir()),
            {p.name: p.read_bytes() for p in (tmp_path / side / "res").iterdir()}, saved,
        )
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["epoch001_fake.jpg", "epoch001_real.jpg",
                              "epoch002_fake.jpg", "epoch002_real.jpg"]


def test_dump_visuals_reads_the_last_chunk(tmp_path):
    """train_cli.dump_visuals shows Trainer.last_outs and last_inputs, which
    train_chunk sets: the last frame of the first clip, HWC uint8."""
    opt = Options(**TINY, checkpoints_dir=str(tmp_path), no_html=True)
    trainer = Trainer(opt, device="cpu")
    state = trainer.init_state()
    shown = []
    visualizer = Visualizer(opt)
    visualizer.display_current_results = lambda v, e, s: shown.append((v, e, s))
    train_cli.dump_visuals(opt, trainer, visualizer, 1, 0)
    assert trainer.last_outs is None and shown == []  # nothing before a chunk

    labels, frames = (torch.from_numpy(a) for a in moving_square_clip(
        np.random.default_rng(0), 6, 32, 32, 4))
    trainer.train_clip(state, labels, frames)
    outs, (last_labels, real_b, flow_ref, conf_ref) = trainer.last_outs, trainer.last_inputs
    assert outs.fake.shape == (1, 2, 3, 32, 32) and real_b.shape == (1, 4, 3, 32, 32)
    torch.testing.assert_close(real_b, frames[:, 2:], rtol=0, atol=0)  # the last chunk
    train_cli.dump_visuals(opt, trainer, visualizer, 1, 6)
    (visuals, epoch, step), = shown
    assert (epoch, step) == (1, 6)
    assert set(visuals) == {"input_label", "fake_image", "fake_raw_image", "real_image",
                            "flow_ref", "conf_ref"}  # no flow branch under --no_flow

    def hwc(x):
        return x[0, -1].numpy().transpose(1, 2, 0)

    np.testing.assert_array_equal(visuals["fake_image"], images.to_image(hwc(outs.fake)))
    np.testing.assert_array_equal(visuals["fake_raw_image"], images.to_image(hwc(outs.raw)))
    np.testing.assert_array_equal(visuals["real_image"], images.to_image(hwc(frames[:, 2:])))
    np.testing.assert_array_equal(visuals["input_label"],
                                  images.label_to_color(labels[0, -1].numpy(), 4))
    np.testing.assert_array_equal(visuals["conf_ref"], np.full((32, 32, 3), 255, np.uint8))
    assert all(v.dtype == np.uint8 and v.shape == (32, 32, 3) for v in visuals.values())


class ClipDataset:
    """Two in-memory moving-square clips in TemporalDataset's item layout."""

    seq_len_max = 6

    def __init__(self, h=32, w=32):
        rng = np.random.default_rng(0)
        self.clips = [moving_square_clip(rng, 6, h, w, 4) for _ in range(2)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        labels, frames = self.clips[i]
        return {"A": labels[0], "B": frames[0], "inst": None, "A_path": f"clip{i}", "seq": i}


def test_train_cli_runs_without_pil(tmp_path, monkeypatch, capsys):
    """--no_html: one tiny epoch of train_cli.train on an injected dataset,
    visuals dumped and a checkpoint saved, with every import of PIL failing."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    opt = Options(**TINY, checkpoints_dir=str(tmp_path), no_html=True, display_freq=1,
                  print_freq=1, serial_batches=True)
    trainer, _ = train_cli.train(opt, dataset=ClipDataset())
    assert trainer.schedule.epoch == 2 and trainer.schedule.total_steps == 4
    assert (tmp_path / "tiny" / "latest_optim.pth").exists()
    assert not (tmp_path / "tiny" / "web").exists()
    out = capsys.readouterr().out
    assert out.count("(epoch: 1, iters: ") == 2 and "End of epoch 1 / 1" in out
