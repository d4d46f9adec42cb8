"""The port's training CLI end to end on the CPU (--gpu_ids -1), at
tests/test_train.py::TestTrainTestRoundTrip's tiny size, on a tree written
by tests/test_data.py::write_temporal_dataset: one epoch, a
--continue_train run that replays it from the saved state, and the test
CLI on the saved generator.

One sequence exactly one clip long, with --serial_batches and --no_flip,
so that nothing drawn changes a clip."""

import os

import pytest
import torch

from test_data import write_temporal_dataset
from torch_parity import torch_threads
from vid2vid_tpu_torch import test_cli, train_cli
from vid2vid_tpu_torch.config import parse_args
from vid2vid_tpu_torch.data.loader import create_dataset
from vid2vid_tpu_torch.train.checkpoints import restore_checkpoint
from vid2vid_tpu_torch.train.loop import Trainer


def _flags(root):
    common = [
        "--dataroot", str(root), "--name", "roundtrip",
        "--checkpoints_dir", str(root / "ckpt"), "--label_nc", "5",
        "--loadSize", "64", "--fineSize", "64", "--resize_or_crop", "scaleWidth",
        "--ngf", "8", "--ndf", "8", "--n_blocks", "2", "--n_downsample_G", "2",
        "--n_scales_spatial", "1", "--n_frames_G", "3", "--norm", "batch", "--no_flow",
        "--gpu_ids", "-1",
    ]
    train = common + [
        "--n_frames_total", "4", "--max_frames_per_gpu", "2", "--num_D", "1",
        "--n_layers_D", "2", "--n_frames_D", "3", "--n_scales_temporal", "1", "--no_vgg",
        "--niter", "1", "--niter_decay", "0", "--serial_batches", "--no_flip",
    ]
    return common, train


def test_train_resume_and_test_cli(tmp_path, monkeypatch, capsys):
    write_temporal_dataset(str(tmp_path), n_seqs=1, n_frames=6)  # 4 frames + tG - 1
    for sub in ("test_A", "test_B"):
        os.symlink(tmp_path / sub.replace("test", "train"), tmp_path / sub)
    common, train_flags = _flags(tmp_path)
    run = tmp_path / "ckpt" / "roundtrip"

    trainer, _ = train_cli.main(train_flags)
    assert trainer.schedule.epoch == 2 and trainer.schedule.total_steps == 2  # 2 chunks
    assert (run / "iter.txt").read_text() == "1 0"  # saved before the epoch's end
    # every save recalibrates the norms' running statistics first
    g0 = torch.load(run / "latest_net_G0.pth", weights_only=True)
    means = [v for k, v in g0.items() if k.endswith("running_mean")]
    assert means and any(float(m.abs().max()) > 1e-6 for m in means)

    # --continue_train replays epoch 1 from the saved state; its first clip
    # gives what restore_checkpoint + train_clip give here
    opt = parse_args(train_flags, is_train=True, save=False)
    trainer = Trainer(opt, device="cpu")
    state, _ = restore_checkpoint(opt, trainer.init_state(), trainer.schedule)
    item = create_dataset(opt)[0]
    _, want = trainer.train_clip(state, torch.from_numpy(item["A"][None]),
                                 torch.from_numpy(item["B"][None]))
    first = []
    train_clip = Trainer.train_clip

    def record(self, *args):
        out = train_clip(self, *args)
        first.append(out[1])
        return out

    monkeypatch.setattr(Trainer, "train_clip", record)
    resumed, _ = train_cli.main(train_flags + ["--continue_train"])
    monkeypatch.undo()
    assert len(first) == 1 and resumed.schedule.epoch == 2

    assert first[0].keys() == want.keys() and len(want) > 10
    for k, v in want.items():
        assert first[0][k] == pytest.approx(v, rel=1e-6, abs=1e-6), k

    # the test CLI streams the saved generator: real_A and fake_B per frame
    capsys.readouterr()
    results = tmp_path / "results"
    assert test_cli.main(common + ["--how_many", "4", "--results_dir", str(results)]) == 4
    written = sorted(p.name for p in (results / "roundtrip" / "test_latest").iterdir())
    assert written == sorted(f"{k:05d}_{label}.jpg" for k in range(2, 6)
                             for label in ("real_A", "fake_B"))
    assert "randomly initialized generator" not in capsys.readouterr().out


class _TinyFlow(torch.nn.Module):
    """FlowEstimator's shape for _build_flow_fn: the flow net under `.net`."""

    def __init__(self):
        super().__init__()
        self.net = torch.nn.Conv2d(2, 2, 1)


def test_flow_fn_loads_the_published_file_or_seeds(tmp_path, monkeypatch, capsys):
    """_build_flow_fn reads `state_dict` from
    <checkpoints_dir>/flownet2/FlowNet2_checkpoint.pth.tar, or seeds the nets
    with the flow nets' init and warns."""
    monkeypatch.setattr(train_cli, "FlowEstimator", _TinyFlow)
    seeded = []
    monkeypatch.setattr(train_cli, "init_flownet_weights", lambda est, g: seeded.append(est))
    opt = parse_args(["--checkpoints_dir", str(tmp_path), "--gpu_ids", "-1"], save=False)
    est = train_cli._build_flow_fn(opt, torch.device("cpu"))
    assert seeded == [est] and not est.training
    assert "WARNING: no FlowNet2 weights" in capsys.readouterr().out

    published = _TinyFlow().net.state_dict()
    os.makedirs(tmp_path / "flownet2")
    torch.save({"epoch": 3, "state_dict": published},
               tmp_path / "flownet2" / "FlowNet2_checkpoint.pth.tar")
    est = train_cli._build_flow_fn(opt, torch.device("cpu"))
    assert len(seeded) == 1 and "WARNING" not in capsys.readouterr().out
    for k, v in est.net.state_dict().items():
        assert torch.equal(v, published[k]), k


def test_train_cli_pose_with_face_disc(tmp_path, capsys):
    """--dataset_mode pose --add_face_disc for one epoch on the CPU: pose
    items (inst None) from the files, the face discriminator's losses
    printed, its checkpoint file saved and restored."""
    from test_torch_face_pose_data import write_pose_tree

    # 96x256 frames: scaleHeight 96 keeps them; the scaled crop (fineSize
    # 64) gives 64x160, the central crop 64x64, a 16-square face window
    write_pose_tree(str(tmp_path), n_seqs=2, n_frames=5, hw=(96, 256), faceless=())
    flags = [
        "--dataroot", str(tmp_path), "--dataset_mode", "pose", "--name", "pose",
        "--checkpoints_dir", str(tmp_path / "ckpt"), "--label_nc", "0", "--input_nc", "6",
        "--resize_or_crop", "scaleHeight_and_scaledCrop", "--loadSize", "96",
        "--fineSize", "64", "--ngf", "8", "--ndf", "8", "--n_blocks", "1",
        "--n_downsample_G", "2", "--n_scales_spatial", "1", "--n_frames_total", "2",
        "--max_frames_per_gpu", "1", "--num_D", "3", "--n_layers_D", "2",
        "--n_scales_temporal", "1", "--no_vgg", "--no_flow", "--no_first_img",
        "--add_face_disc", "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
        "--gpu_ids", "-1",
    ]
    with torch_threads(1):
        trainer, state = train_cli.main(flags)
    # 2 clips of 2 + tG - 1 frames, one frame a chunk
    assert trainer.schedule.epoch == 2 and trainer.schedule.total_steps == 4
    assert trainer.engine.netD_f.num_d == 1
    out = capsys.readouterr().out
    assert "D_f_real" in out and "G_f_GAN" in out
    run = tmp_path / "ckpt" / "pose"
    assert (run / "latest_net_D_f.pth").exists()
    opt = parse_args(flags, is_train=True, save=False)
    fresh = Trainer(opt, device="cpu")
    fstate, _ = restore_checkpoint(opt, fresh.init_state(), fresh.schedule)
    for k, v in trainer.engine.netD_f.state_dict().items():
        assert torch.equal(fstate.engine.netD_f.state_dict()[k], v), k
