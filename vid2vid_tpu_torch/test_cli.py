"""Streaming inference CLI — the port of vid2vid_tpu/test_cli.py.

    python -m vid2vid_tpu_torch.test_cli --dataroot datasets/Cityscapes \\
        --label_nc 35 --use_instance --fg --n_scales_spatial 3 ...

Takes the reference's test.py flags (vid2vid_tpu_torch/config.py), streams
the test set of --dataset_mode (label maps, face landmarks, or DensePose and
OpenPose renders: data/loader.py::create_test_stream) frame by frame
through the generator on the first CUDA device
(on the CPU with `--gpu_ids -1`; without a card and that flag it raises),
resets the state at every sequence change, and writes each frame's label
map and generated frame to results/<name>/<phase>_<epoch>/<frame>_real_A.jpg
and <frame>_fake_B.jpg (utils/visualizer.py::Visualizer.save_images; an
RGB input's real_A is its first three channels). In face mode each item's
part map ("inst") is also the pool map of the --use_single_G seeding.
Weights: the reference's per-scale checkpoints
`<checkpoints_dir>/<name>/<which_epoch>_net_G<s>.pth`, loaded with
load_state_dict; without them the generator runs on its seeded random
initialization (with a warning). `--use_single_G` seeds each sequence with
the single-image generator of the registry (models/inference.py::
make_single_image_generator), whose reference-named weights are
`<checkpoints_dir>/label2city_single/G_<loadSize>.pth`, or
`edge2face_single/G.pth`, `E.pth` and the clusters `features.npy` for
faces; missing files give a warning and a seeded initialization (empty
clusters), as for the generator.

`--n_devices N > 1` serves each frame width-sharded on N ranks (the
model axis: models/inference.py), started here through parallel.launch:
rank r on cuda:r, or with `--gpu_ids -1` gloo ranks on the CPU; under
torchrun this process is one rank. Every rank reads the stream and gets
the whole frames; rank 0 alone writes them.
"""

from __future__ import annotations

import os
from collections.abc import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from vid2vid_tpu_torch.config import Options, parse_args
from vid2vid_tpu_torch.data.loader import create_test_stream
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.layers import init_weights
from vid2vid_tpu_torch.parallel.mesh import launch, visible_devices
from vid2vid_tpu_torch.utils.device import require_device
from vid2vid_tpu_torch.utils.images import label_to_color, to_image
from vid2vid_tpu_torch.utils.visualizer import Visualizer


def stream_frames(
    opt: Options, eng: InferenceEngine, stream: Iterable[dict]
) -> Iterator[tuple[dict, torch.Tensor]]:
    """The streaming loop: yields (item, (1, 3, H, W) float32 frame).

    Per sequence: the first tG-1 items only fill the window (the first
    output frame is at index tG-1); the state is seeded by the single-image
    generator under --use_single_G (`load_single_g` builds and loads it at
    first use), from the real frames under --use_real_img (when
    the stream has them), else with zeros; under --no_first_img the first
    frame is the raw, unwarped output.
    """
    tG = opt.n_frames_G
    state = None
    window: list = []   # labels
    bwindow: list = []  # real frames
    iwindow: list = []  # instance maps
    count = 0
    for item in stream:
        if count >= opt.how_many:
            break
        if item["change_seq"]:
            state = None
            window, bwindow, iwindow = [], [], []
        window.append(item["A"])
        if item.get("B") is not None:
            bwindow.append(item["B"])
        if item.get("inst") is not None:
            iwindow.append(item["inst"])
        window, bwindow, iwindow = window[-tG:], bwindow[-tG:], iwindow[-tG:]
        if len(window) < tG:
            continue

        labels = np.stack(window)[None]  # (1, tG, H, W) ids or (1, tG, H, W, C)
        if labels.ndim == 5:
            labels = np.ascontiguousarray(np.moveaxis(labels, -1, 2))
        labels = torch.from_numpy(labels)
        inst = torch.from_numpy(np.stack(iwindow)[None]) if iwindow else None
        use_raw_only = False
        if state is None:
            if opt.use_single_G:
                if eng.single_g is None:
                    load_single_g(opt, eng)
                state = single_g_state(opt, eng, labels, inst, bwindow, iwindow)
            elif bwindow and opt.use_real_img:
                real = np.stack(bwindow[: tG - 1])[None]  # (1, tG-1, H, W, 3)
                state = eng.seed_state(torch.from_numpy(real).permute(0, 1, 4, 2, 3))
            else:
                state = eng.initial_state(1, *item["A"].shape[:2])
            use_raw_only = opt.no_first_img
        frame, state = eng.step(labels, inst, state, use_raw_only=use_raw_only)
        count += 1
        yield item, frame


def load_weights(opt: Options, eng: InferenceEngine) -> bool:
    """Load `<which_epoch>_net_G<s>.pth` for every scale; False (and a
    seeded random init) when any is missing."""
    root = os.path.join(opt.checkpoints_dir, opt.name)
    paths = [
        os.path.join(root, f"{opt.which_epoch}_net_G{s}.pth")
        for s in range(opt.n_scales_spatial)
    ]
    if not all(os.path.exists(p) for p in paths):
        print(
            f"WARNING: no checkpoint '{opt.which_epoch}_net_G*.pth' under {root}"
            " — using a randomly initialized generator."
        )
        init_weights(eng.gen, torch.Generator().manual_seed(opt.seed))
        return False
    sd = {}
    for s, p in enumerate(paths):
        payload = torch.load(p, map_location="cpu", weights_only=True)
        sd.update({f"G{s}.{k}": v for k, v in payload.items()})
    eng.load_state_dict(sd)
    return True


def _registry(opt: Options) -> tuple[str, str]:
    """(directory, generator file) of the single-image registry."""
    if "city" in opt.dataroot.lower():
        return os.path.join(opt.checkpoints_dir, "label2city_single"), f"G_{opt.loadSize}.pth"
    return os.path.join(opt.checkpoints_dir, "edge2face_single"), "G.pth"


def load_single_g(opt: Options, eng: InferenceEngine) -> None:
    """Build the single-image generator (and the face Encoder) and load
    their registry weights, or seed them with a warning when a file is
    missing; faces also load the clusters into eng.feature_clusters ({}
    without features.npy)."""
    root, g_name = _registry(opt)
    eng.build_single_g()
    nets = [(eng.single_g, os.path.join(root, g_name))]
    if eng.encoder is not None:
        nets.append((eng.encoder, os.path.join(root, "E.pth")))
    for i, (net, path) in enumerate(nets):
        if os.path.exists(path):
            net.load_state_dict(torch.load(path, map_location=eng.device, weights_only=True))
        else:
            print(f"WARNING: no single-image checkpoint {path} — using a randomly "
                  "initialized network.")
            init_weights(net, torch.Generator().manual_seed(opt.seed + 1 + i))
    if eng.encoder is not None:
        fpath = os.path.join(root, "features.npy")
        eng.feature_clusters = (np.load(fpath, allow_pickle=True).item()
                                if os.path.exists(fpath) else {})


def single_g_state(opt: Options, eng: InferenceEngine, labels: torch.Tensor,
                   inst: torch.Tensor | None, bwindow: list, iwindow: list):
    """The --use_single_G seed: the single-image generator on the window's
    first tG-1 encoded label maps; faces also take the sequence's first
    real frames and part maps (zeros when the stream has none)."""
    tg1 = opt.n_frames_G - 1
    enc = eng.encode(labels, inst)[:, :tg1]
    real_first = pool_map = None
    if eng.single_needs_feat:
        hw = enc.shape[-2:]
        reals = bwindow[:tg1] if bwindow else [np.zeros(hw + (3,), np.float32)] * tg1
        parts = iwindow[:tg1] if iwindow else [np.zeros(hw, np.int32)] * tg1
        real_first = torch.from_numpy(np.stack(reals)[None]).permute(0, 1, 4, 2, 3)
        pool_map = torch.from_numpy(np.stack(parts)[None])
    return eng.single_g_first_frames(enc, real_first, pool_map, eng.feature_clusters)


def save_frame(visualizer: Visualizer, save_dir: str, opt: Options, item: dict,
               frame: torch.Tensor) -> list[str]:
    """The item's label map and its (1, 3, H, W) frame in [-1, 1] ->
    <save_dir>/<frame>_real_A.jpg and <frame>_fake_B.jpg, with the JAX
    package's conversions (label_to_color, or the first 3 channels of an
    RGB input; to_image: (x + 1) / 2 * 255, truncated)."""
    a = item["A"]
    visuals = {
        "real_A": label_to_color(a, opt.label_nc) if opt.label_nc > 0 else to_image(a[..., :3]),
        "fake_B": to_image(frame[0].permute(1, 2, 0).float().cpu().numpy()),
    }
    return visualizer.save_images(save_dir, visuals, item["path"])


def main(argv=None) -> int:
    """Run the CLI; returns the number of frames written (with --n_devices
    N > 1, rank 0's count)."""
    opt = parse_args(argv, is_train=False, save=False)
    opt = opt.replace(
        phase="test" if opt.phase == "train" else opt.phase,
        nThreads=1, serial_batches=True, no_flip=True, isTrain=False,
        dataset_mode="test" if opt.dataset_mode == "temporal" else opt.dataset_mode,
    )
    n = visible_devices(opt.n_devices, require_device("cuda" if opt.gpu_ids else "cpu"))
    if n > 1 and not (dist.is_available() and dist.is_initialized()):
        devices = [f"cuda:{r}" if opt.gpu_ids else "cpu" for r in range(n)]
        # CPU ranks share the cores: each takes its share of intra-op threads
        threads = None if opt.gpu_ids else max(1, torch.get_num_threads() // n)
        return launch(run_rank, n, args=(opt,), devices=devices, threads=threads)[0]
    return run_rank(opt)


def run_rank(opt: Options) -> int:
    """The CLI in this process, or as one rank of --n_devices' model axis
    (the group joined): every rank streams, rank 0 alone writes. Returns
    the number of frames streamed."""
    writer = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    eng = InferenceEngine(opt, device="cuda" if opt.gpu_ids else "cpu")
    stream = create_test_stream(opt)
    visualizer = Visualizer(opt) if writer else None
    load_weights(opt, eng)
    if opt.use_single_G:
        load_single_g(opt, eng)
    save_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.which_epoch}")
    if writer:
        os.makedirs(save_dir, exist_ok=True)
    count = 0
    for item, frame in stream_frames(opt, eng, stream):
        if writer:
            save_frame(visualizer, save_dir, opt, item, frame)
        count += 1
        if writer and count % 10 == 0:
            print(f"processed {count} frames -> {save_dir}")
    if writer:
        print(f"done: {count} frames written to {save_dir}")
    return count


if __name__ == "__main__":
    main()
