"""Configuration for vid2vid_tpu_torch: the port's own copy of
vid2vid_tpu/config.py (the same fields, defaults and flags;
tests/test_torch_imports.py holds the two equal).

One flat dataclass mirroring the reference's flag surface (reference:
options/base_options.py, options/train_options.py, options/test_options.py)
so every published recipe maps 1:1, plus an argparse shim (`build_parser` /
`parse_args`) exposing the exact reference flag names.

`--gpu_ids -1` (an empty `gpu_ids`) selects the CPU in the port's CLIs;
otherwise they run on the first CUDA device. `max_frames_per_gpu` scales
the per-chunk frame count (`n_frames_load = max_frames_per_gpu *
n_devices`), mirroring the reference's chunking math (reference:
data/base_dataset.py:56-63).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass


@dataclass
class Options:
    # data
    dataroot: str = "datasets/Cityscapes/"
    batchSize: int = 1
    loadSize: int = 512
    fineSize: int = 512
    input_nc: int = 3
    label_nc: int = 0
    output_nc: int = 3
    dataset_mode: str = "temporal"  # temporal | face | pose | test
    nThreads: int = 2
    max_dataset_size: int = 2**31
    resize_or_crop: str = "scaleWidth"
    no_flip: bool = False
    serial_batches: bool = False
    use_instance: bool = False

    # arch
    netG: str = "composite"
    ngf: int = 128
    ndf: int = 64
    n_blocks: int = 9
    n_downsample_G: int = 3
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    norm: str = "batch"
    feat_num: int = 3
    nef: int = 32
    netE: str = "simple"
    n_downsample_E: int = 3
    label_feat: bool = False
    load_features: bool = False

    # temporal
    n_frames_G: int = 3
    n_scales_spatial: int = 1
    no_first_img: bool = False
    use_single_G: bool = False
    fg: bool = False
    fg_labels: tuple[int, ...] = (26,)
    no_flow: bool = False

    # face
    no_canny_edge: bool = False
    no_dist_map: bool = False
    random_scale_points: bool = False

    # pose
    densepose_only: bool = False
    openpose_only: bool = False
    add_face_disc: bool = False
    remove_face_labels: bool = False
    random_drop_prob: float = 0.05
    basic_point_only: bool = False

    # device topology: an empty gpu_ids (--gpu_ids -1) is the CPU; n_devices
    # N > 1 is one rank of N (parallel/mesh.py): training's data x model
    # mesh, serving's width-sharded model axis
    gpu_ids: tuple[int, ...] = (0,)
    n_gpus_gen: int = -1
    n_devices: int = 1

    # experiment
    name: str = "experiment_name"
    checkpoints_dir: str = "./checkpoints"
    model: str = "vid2vid"
    load_pretrain: str = ""
    debug: bool = False
    fp16: bool = False  # the reference's flag; selects the bf16 policy
    local_rank: int = 0
    tf_log: bool = False
    no_html: bool = False  # skip the web/ HTML gallery (reference: util/visualizer.py:18)
    display_winsize: int = 512
    display_id: int = 0

    # training (reference: options/train_options.py)
    isTrain: bool = True
    display_freq: int = 100
    print_freq: int = 100
    save_latest_freq: int = 1000
    save_epoch_freq: int = 1
    continue_train: bool = False
    which_epoch: str = "latest"
    phase: str = "train"
    niter: int = 10
    niter_decay: int = 10
    niter_step: int = 5
    niter_fix_global: int = 0
    beta1: float = 0.5
    lr: float = 0.0002
    TTUR: bool = False
    gan_mode: str = "ls"
    pool_size: int = 1
    num_D: int = 2
    n_layers_D: int = 3
    no_vgg: bool = False
    no_ganFeat: bool = False
    lambda_feat: float = 10.0
    sparse_D: bool = False
    lambda_T: float = 10.0
    lambda_F: float = 10.0
    n_frames_D: int = 3
    n_scales_temporal: int = 2
    max_frames_per_gpu: int = 1
    max_frames_backpropagate: int = 1
    max_t_step: int = 1
    n_frames_total: int = 30

    # testing (reference: options/test_options.py)
    how_many: int = 300
    use_real_img: bool = False
    start_frame: int = 0
    results_dir: str = "./results/"

    # extensions of the JAX package (no reference analog)
    bf16: bool = False  # bfloat16 generator compute, f32 master weights
    remat: bool = False  # recompute each generator scale in the backward
    pallas_resblocks: bool = False  # eval resblocks through the respair kernel
    seed: int = 0

    @property
    def tG(self) -> int:
        return self.n_frames_G

    @property
    def gen_input_nc(self) -> int:
        """Channels of the encoded per-frame generator input."""
        nc = self.label_nc if self.label_nc != 0 else self.input_nc
        if self.use_instance:
            nc += 1
        return nc

    @property
    def effective_no_flow(self) -> bool:
        # openpose-only mode disables flow (reference: vid2vid_model_G.py:35-36)
        return self.no_flow or self.openpose_only

    def ngf_at_scale(self, s: int) -> int:
        return self.ngf // (2**s)

    @property
    def n_frames_load(self) -> int:
        """Frames generated per chunk (reference: base_dataset.py:59-60)."""
        n = min(self.max_frames_per_gpu * max(self.n_devices, 1),
                self.n_frames_total)
        return max(n, 1)

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


_CSV_FIELDS = {"fg_labels", "gpu_ids"}
_TRAIN_ONLY = {
    "display_freq", "print_freq", "save_latest_freq", "save_epoch_freq",
    "continue_train", "niter", "niter_decay", "niter_step",
    "niter_fix_global", "beta1", "lr", "TTUR", "gan_mode", "pool_size",
    "num_D", "n_layers_D", "no_vgg", "no_ganFeat", "lambda_feat", "sparse_D",
    "lambda_T", "lambda_F", "n_frames_D", "n_scales_temporal",
    "max_frames_per_gpu", "max_frames_backpropagate", "max_t_step",
    "n_frames_total",
}
_TEST_ONLY = {"how_many", "use_real_img", "start_frame", "results_dir"}


def build_parser(is_train: bool) -> argparse.ArgumentParser:
    """argparse parser exposing the reference's flag names."""
    parser = argparse.ArgumentParser()
    skip = _TEST_ONLY if is_train else _TRAIN_ONLY
    skip = skip | {"isTrain"}
    for f in dataclasses.fields(Options):
        if f.name in skip:
            continue
        flag = "--" + f.name
        default = f.default
        if f.name in _CSV_FIELDS:
            parser.add_argument(
                flag, type=str, default=",".join(str(v) for v in default)
            )
        elif f.type == "bool" or isinstance(default, bool):
            if default:
                parser.add_argument(flag, action="store_false")
            else:
                parser.add_argument(flag, action="store_true")
        else:
            parser.add_argument(flag, type=type(default), default=default)
    return parser


def parse_args(argv=None, is_train: bool = True, save: bool = True) -> Options:
    """Parse reference-style CLI flags into an Options dataclass.

    Mirrors the side effects of the reference's BaseOptions.parse
    (reference: options/base_options.py:96-128): csv list conversion and
    an opt.txt dump under checkpoints/<name>/.
    """
    ns = build_parser(is_train).parse_args(argv)
    kw = vars(ns)
    for name in _CSV_FIELDS:
        kw[name] = tuple(
            int(v) for v in str(kw[name]).split(",") if v.strip() != "" and int(v) >= 0
        )
    kw["isTrain"] = is_train
    opt = Options(**kw)

    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    if save:
        with open(os.path.join(expr_dir, "opt.txt"), "w") as fh:
            fh.write("------------ Options -------------\n")
            for k, v in sorted(dataclasses.asdict(opt).items()):
                fh.write(f"{k}: {v}\n")
            fh.write("-------------- End ----------------\n")
    return opt
