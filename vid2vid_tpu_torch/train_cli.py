"""The training CLI, the port of vid2vid_tpu/train_cli.py (reference:
train.py:14-128).

    python -m vid2vid_tpu_torch.train_cli --name label2city_512 --label_nc 35 \\
        --loadSize 512 --use_instance --fg --n_frames_total 6 ...

Takes the reference's train.py flags (config.py) and runs the epoch ->
clip -> chunk loop on the first CUDA device (on the CPU with `--gpu_ids
-1`; without a card and that flag it raises): losses printed and plotted,
the last chunk's visuals dumped, and `latest` (and every save_epoch_freq
epochs `<epoch>`) checkpoints under <checkpoints_dir>/<name>/
(train/checkpoints.py), each after the generator's norm statistics are
recalibrated on the 4 most recent clips; at each epoch's end the lr decay,
curriculum and unfreeze schedules advance.

`--continue_train` restores `latest`. As in the JAX package, the `latest`
save at the end of epoch e comes before the schedule advances, so a resumed
run replays epoch e from the saved state. `--load_pretrain <dir>` warm-starts
from another run's directory (entries of other names or shapes stay at
init). The reference flow is FlowNet2 with the published weights
<checkpoints_dir>/flownet2/FlowNet2_checkpoint.pth.tar when present, else
seeded weights with a warning.
"""

from __future__ import annotations

import os
import time

import torch

from vid2vid_tpu_torch.config import Options, parse_args
from vid2vid_tpu_torch.data.loader import PrefetchLoader, create_dataset
from vid2vid_tpu_torch.models.flownet2.nets import init_flownet_weights
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator
from vid2vid_tpu_torch.train.checkpoints import (
    checkpoint_exists,
    load_pretrain,
    restore_checkpoint,
    save_checkpoint,
)
from vid2vid_tpu_torch.train.loop import Trainer, refresh_batch_stats
from vid2vid_tpu_torch.utils.device import require_device
from vid2vid_tpu_torch.utils.images import flow_to_color, label_to_color, to_image
from vid2vid_tpu_torch.utils.profiling import device_memory_stats
from vid2vid_tpu_torch.utils.visualizer import Visualizer

FLOWNET2_WEIGHTS = os.path.join("flownet2", "FlowNet2_checkpoint.pth.tar")


def main(argv=None):
    return train(parse_args(argv, is_train=True))


def train(opt: Options, dataset=None, flow_fn=None):
    """Train by `opt`'s schedule; returns (trainer, state).

    `dataset` (default: create_dataset(opt)) yields TemporalDataset's items;
    `flow_fn` (default: FlowNet2, or zero flow under --no_flow) computes
    the reference flow, as Trainer takes it."""
    if opt.debug:
        opt = opt.replace(display_freq=1, print_freq=1, nThreads=1)
    device = require_device("cuda" if opt.gpu_ids else "cpu")
    if dataset is None:
        dataset = create_dataset(opt)
    loader = PrefetchLoader(dataset, opt)
    print(f"#training videos = {len(loader)}")
    if flow_fn is None and not opt.effective_no_flow:
        flow_fn = _build_flow_fn(opt, device)

    trainer = Trainer(opt, flow_fn=flow_fn, device=device)
    sched = trainer.schedule
    sched.seq_len_max = getattr(dataset, "seq_len_max", 128)
    visualizer = Visualizer(opt)
    state = trainer.init_state()
    if opt.continue_train and checkpoint_exists(opt):
        state, sched = restore_checkpoint(opt, state, sched)
        visualizer.vis_print(
            f"resumed at epoch {sched.epoch}, n_frames_total {sched.n_frames_total}")
    elif opt.load_pretrain:
        state = load_pretrain(opt, state)

    # the 4 most recent clips, on the host: every save first recalibrates
    # the generator's norm statistics on them (training normalizes with
    # batch statistics and leaves the running ones), so eval-mode inference
    # of a saved generator is right
    recent: list = []

    def save(tag: str):
        if recent:
            refresh_batch_stats(trainer, state, recent, n_batches=len(recent))
        save_checkpoint(opt, state, sched, tag)

    total_epochs = opt.niter + opt.niter_decay
    while sched.epoch <= total_epochs:
        epoch = sched.epoch
        epoch_start = time.time()
        if hasattr(dataset, "set_n_frames_total"):
            dataset.set_n_frames_total(sched.n_frames_total)
        for idx, data in enumerate(loader):
            iter_start = time.time()
            inst = data.get("inst")
            clip = (torch.from_numpy(data["A"]), torch.from_numpy(data["B"]),
                    None if inst is None else torch.from_numpy(inst))
            state, losses = trainer.train_clip(state, *clip)
            recent = recent[-3:] + [clip]

            if sched.total_steps % opt.print_freq < opt.batchSize:
                visualizer.print_current_errors(epoch, idx, losses, time.time() - iter_start)
                visualizer.plot_current_errors(losses, sched.total_steps)
            if sched.total_steps % opt.display_freq < opt.batchSize:
                dump_visuals(opt, trainer, visualizer, epoch, sched.total_steps)
            if sched.total_steps % opt.save_latest_freq < opt.batchSize:
                save("latest")
            if opt.debug and device.type == "cuda":
                index = torch.cuda.current_device() if device.index is None else device.index
                st = device_memory_stats()[f"cuda:{index}"]
                print(f"  {device}: {st['bytes_in_use'] / 1e9:.2f} / "
                      f"{st['bytes_limit'] / 1e9:.2f} GB")

        visualizer.vis_print(
            f"End of epoch {epoch} / {total_epochs} \t "
            f"Time Taken: {time.time() - epoch_start:.0f} sec")
        save("latest")
        if epoch % opt.save_epoch_freq == 0:
            save(str(epoch))
        state = trainer.end_of_epoch(state)
    return trainer, state


def dump_visuals(opt: Options, trainer: Trainer, visualizer: Visualizer, epoch: int, step: int):
    """The reference's save_all_tensors (util/util.py:13-44): the last
    frame of the first clip of the last chunk, inputs and outputs, to the
    gallery."""
    outs = trainer.last_outs
    if outs is None:
        return
    labels, real_b, flow_ref, conf_ref = trainer.last_inputs

    def hwc(x):
        return x[0, -1].detach().float().cpu().numpy().transpose(1, 2, 0)

    visuals = {
        "input_label": (
            label_to_color(labels[0, -1].cpu().numpy(), opt.label_nc)
            if opt.label_nc > 0 else to_image(hwc(labels)[..., :3])
        ),
        "fake_image": to_image(hwc(outs.fake)),
        "fake_raw_image": to_image(hwc(outs.raw)),
        "real_image": to_image(hwc(real_b)),
        "flow_ref": flow_to_color(hwc(flow_ref)),
        "conf_ref": to_image(hwc(conf_ref) * 2 - 1),
    }
    if outs.flow is not None:
        visuals["flow"] = flow_to_color(hwc(outs.flow))
        visuals["weight"] = to_image(hwc(outs.weight) * 2 - 1)
    visualizer.display_current_results(visuals, epoch, step)


def _build_flow_fn(opt: Options, device: torch.device) -> FlowEstimator:
    """FlowNet2 with the published weights (the reference's state-dict
    names), or seeded weights with a warning."""
    est = FlowEstimator()
    path = os.path.join(opt.checkpoints_dir, FLOWNET2_WEIGHTS)
    if os.path.exists(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        est.net.load_state_dict(payload["state_dict"])
    else:
        print(
            f"WARNING: no FlowNet2 weights at {path} — using a randomly "
            "initialized flow net (train flow supervision will be weak; place "
            "the published FlowNet2_checkpoint.pth.tar there)."
        )
        init_flownet_weights(est, torch.Generator().manual_seed(opt.seed))
    return est.to(device).eval()


if __name__ == "__main__":
    main()
