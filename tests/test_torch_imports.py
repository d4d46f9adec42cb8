"""Importing the port (and what chip_smoke.py imports) loads neither JAX,
PIL, cv2 nor the JAX package and builds no kernel; the port's copies of the JAX
package's config and name mappings equal the originals; and a CUDA-only
entry without a GPU raises instead of falling back."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vid2vid_tpu import config as jax_config
from vid2vid_tpu.utils import torch_import
from vid2vid_tpu_torch import config
from vid2vid_tpu_torch.ops.conv3 import conv3_fused_padded, conv3_padded
from vid2vid_tpu_torch.ops.conv7 import conv7_halo, conv7_padded, conv7_reflect
from vid2vid_tpu_torch.ops.correlation import correlation, correlation_bwd
from vid2vid_tpu_torch.ops.respair import respair, respair_halo
from vid2vid_tpu_torch.ops.warp import (
    flow_warp,
    flow_warp_bwd,
    warp_blend,
    warp_blend_at,
    warp_blend_at_bwd,
    warp_blend_bwd,
)
from vid2vid_tpu_torch.utils import mappings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, json, pkgutil, subprocess, sys
before = set(sys.modules)
started = []
_popen_init = subprocess.Popen.__init__
def _recording_init(self, *args, **kwargs):
    started.append(str(args[0] if args else kwargs.get("args")))
    _popen_init(self, *args, **kwargs)
subprocess.Popen.__init__ = _recording_init

import vid2vid_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    vid2vid_tpu_torch.__path__, "vid2vid_tpu_torch."))
for m in mods + json.loads(sys.argv[1]):
    importlib.import_module(m)
from vid2vid_tpu_torch.kernels import build
loaded = sorted(set(sys.modules) - before)
print(json.dumps({
    "modules": mods,
    "loaded": [m for m in loaded
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "cv2", "vid2vid_tpu")],
    "subprocesses": started,
    "library_loaded": build.library.cache_info().currsize,
}))
"""


def _chip_smoke_imports() -> list[str]:
    """The modules chip_smoke.py imports (it exits before importing them
    on a machine without a card)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return sorted(set(names))


def test_import_loads_no_jax_pil_or_build():
    smoke = _chip_smoke_imports()
    assert "vid2vid_tpu_torch.train.loop" in smoke
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(smoke)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    for name in (
        "vid2vid_tpu_torch.test_cli", "vid2vid_tpu_torch.kernels.build",
        "vid2vid_tpu_torch.ops.respair", "vid2vid_tpu_torch.ops.warp",
        "vid2vid_tpu_torch.models.inference", "vid2vid_tpu_torch.utils.from_jax",
        "vid2vid_tpu_torch.data.test_stream",
        "vid2vid_tpu_torch.ops.correlation", "vid2vid_tpu_torch.ops.channelnorm",
        "vid2vid_tpu_torch.ops.resize",
        "vid2vid_tpu_torch.models.flownet2.nets",
        "vid2vid_tpu_torch.models.flownet2.flownet2",
        "vid2vid_tpu_torch.models.flownet2.wrapper",
        "vid2vid_tpu_torch.models.flownet2.datasets",
        "vid2vid_tpu_torch.models.flownet2.harness",
        "vid2vid_tpu_torch.models.flownet2.main_cli",
        "vid2vid_tpu_torch.config", "vid2vid_tpu_torch.utils.mappings",
        "vid2vid_tpu_torch.losses", "vid2vid_tpu_torch.nn.discriminator",
        "vid2vid_tpu_torch.nn.vgg", "vid2vid_tpu_torch.models.temporal",
        "vid2vid_tpu_torch.models.loss_engine", "vid2vid_tpu_torch.train.state",
        "vid2vid_tpu_torch.train.steps", "vid2vid_tpu_torch.train.loop",
        "vid2vid_tpu_torch.data.synthetic", "vid2vid_tpu_torch.ops.conv7",
        "vid2vid_tpu_torch.ops.conv3", "vid2vid_tpu_torch.nn.pix2pixhd",
        "vid2vid_tpu_torch.train_cli", "vid2vid_tpu_torch.train.checkpoints",
        "vid2vid_tpu_torch.data.files", "vid2vid_tpu_torch.data.transforms",
        "vid2vid_tpu_torch.data.temporal", "vid2vid_tpu_torch.data.loader",
        "vid2vid_tpu_torch.utils.images", "vid2vid_tpu_torch.utils.html",
        "vid2vid_tpu_torch.utils.visualizer", "vid2vid_tpu_torch.data.raster",
        "vid2vid_tpu_torch.data.keypoints", "vid2vid_tpu_torch.data.face",
        "vid2vid_tpu_torch.data.pose", "vid2vid_tpu_torch.ops.library",
        "vid2vid_tpu_torch.utils.profiling", "vid2vid_tpu_torch.tools.export",
        "vid2vid_tpu_torch.tools.train_ledger", "vid2vid_tpu_torch.parallel",
        "vid2vid_tpu_torch.parallel.mesh", "vid2vid_tpu_torch.parallel.workers",
        "vid2vid_tpu_torch.parallel.halo", "vid2vid_tpu_torch.tools.shard_serve_bench",
    ):
        assert name in info["modules"]
    assert info["loaded"] == []
    assert info["subprocesses"] == []  # no nvcc
    assert info["library_loaded"] == 0


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from vid2vid_tpu_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_non_cpu_tensors_never_take_the_plain_path():
    """Only a CPU tensor takes the plain version; any other device goes to
    the CUDA kernel's checks, which reject a non-CUDA device."""
    device = "meta"
    x = torch.zeros(1, 4, 6, 6, device=device)
    k = torch.zeros(4, 4, 3, 3, device=device)
    ab = (torch.ones(4, device=device), torch.zeros(4, device=device))
    before = respair.launches
    with pytest.raises(ValueError, match="not CUDA"):
        respair(x, k, ab, k, ab)
    img = torch.zeros(1, 3, 6, 6, device=device)
    with pytest.raises(ValueError, match="not CUDA"):
        warp_blend(img, img, torch.zeros(1, 2, 6, 6, device=device),
                   torch.zeros(1, 1, 6, 6, device=device))
    assert respair.launches == before


def test_flownet2_wrappers_never_take_the_plain_path_off_cpu():
    """correlation and flow_warp on a non-CPU tensor go to the CUDA kernel's
    checks, which reject a non-CUDA device; no launch is counted."""
    device = "meta"
    f = torch.zeros(1, 8, 6, 6, device=device)
    before = (correlation.launches, flow_warp.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        correlation(f, f)
    img = torch.zeros(1, 3, 6, 6, device=device)
    with pytest.raises(ValueError, match="not CUDA"):
        flow_warp(img, torch.zeros(1, 2, 6, 6, device=device))
    assert (correlation.launches, flow_warp.launches) == before


def test_correlation_backward_never_takes_the_plain_path_off_cpu():
    """correlation_bwd on a non-CPU tensor goes to the CUDA kernel's checks,
    which reject a non-CUDA device; no launch is counted."""
    device = "meta"
    f = torch.zeros(1, 8, 6, 6, device=device)
    before = correlation_bwd.launches
    with pytest.raises(ValueError, match="not CUDA"):
        correlation_bwd(f, f, torch.zeros(1, 441, 6, 6, device=device))
    assert correlation_bwd.launches == before


def test_backward_wrappers_never_take_the_plain_path_off_cpu():
    device = "meta"
    img = torch.zeros(1, 3, 6, 6, device=device)
    flow, w = torch.zeros(1, 2, 6, 6, device=device), torch.zeros(1, 1, 6, 6, device=device)
    before = (flow_warp_bwd.launches, warp_blend_bwd.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        flow_warp_bwd(img, flow, img)
    with pytest.raises(ValueError, match="not CUDA"):
        warp_blend_bwd(img, img, flow, w, img)
    assert (flow_warp_bwd.launches, warp_blend_bwd.launches) == before


def test_conv_wrappers_never_take_the_plain_path_off_cpu():
    """conv7 (both entries), conv3 and conv3_fused on a non-CPU tensor go to
    the CUDA kernel's checks, which reject a non-CUDA device; no launch is
    counted."""
    device = "meta"
    x = torch.zeros(1, 4, 8, 8, device=device)
    w7, w3 = (torch.zeros(2, 4, k, k, device=device) for k in (7, 3))
    ab = torch.ones(2, device=device)
    counters = (conv7_reflect, conv7_padded, conv3_padded, conv3_fused_padded)
    before = [fn.launches for fn in counters]
    for call in (lambda: conv7_reflect(x, w7, ab), lambda: conv7_padded(x, w7),
                 lambda: conv3_padded(x, w3), lambda: conv3_fused_padded(x, w3, ab, ab),
                 lambda: conv3_fused_padded(x, w3, ab, ab, torch.zeros(1, 2, 6, 6,
                                                                       device=device), True)):
        with pytest.raises(ValueError, match="not CUDA"):
            call()
    assert [fn.launches for fn in counters] == before


def test_halo_modes_never_take_the_plain_path_off_cpu():
    """The column-halo modes of a width shard (conv7_halo, respair_halo,
    warp_blend_at) on a non-CPU tensor go to the operators' checks, which
    reject a non-CUDA device; no launch is counted."""
    device = "meta"
    x, x_in = torch.zeros(1, 4, 6, 8, device=device), torch.zeros(1, 4, 6, 16, device=device)
    w7, k = torch.zeros(2, 4, 7, 7, device=device), torch.zeros(4, 4, 3, 3, device=device)
    ab = (torch.ones(4, device=device), torch.zeros(4, device=device))
    img = torch.zeros(1, 3, 6, 8, device=device)
    counters = (conv7_halo, respair_halo, warp_blend_at)
    before = [fn.launches for fn in counters]
    for call in (lambda: conv7_halo(x_in, w7, ab[0][:2], 8, 8, 3),
                 lambda: respair_halo(x, x_in, 8, 2, k, ab, k, ab),
                 lambda: warp_blend_at(img, torch.zeros(1, 3, 6, 16, device=device),
                                       torch.zeros(1, 2, 6, 8, device=device),
                                       torch.zeros(1, 1, 6, 8, device=device), 8)):
        with pytest.raises(ValueError, match="not CUDA"):
            call()
    assert [fn.launches for fn in counters] == before


def test_the_warp_at_an_offset_never_takes_the_plain_path_off_cpu_with_a_gradient():
    """Training's model axis: warp_blend_at with an input that requires a
    gradient, and its backward warp_blend_at_bwd, on a non-CPU tensor go
    to the operator's and the kernel's checks, which reject a non-CUDA
    device; no launch is counted."""
    device = "meta"
    raw, weight = torch.zeros(1, 3, 6, 8, device=device), torch.zeros(1, 1, 6, 8, device=device)
    prev = torch.zeros(1, 3, 6, 16, device=device, requires_grad=True)
    flow = torch.zeros(1, 2, 6, 8, device=device)
    before = (warp_blend_at.launches, warp_blend_at_bwd.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        warp_blend_at(raw, prev, flow, weight, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        warp_blend_at_bwd(raw, prev.detach(), flow, weight, raw, 8)
    assert (warp_blend_at.launches, warp_blend_at_bwd.launches) == before


# ------------------------------------------------------- the port's copies


def test_options_copy_equals_the_jax_config():
    port = {f.name: (f.type, f.default) for f in dataclasses.fields(config.Options)}
    ref = {f.name: (f.type, f.default) for f in dataclasses.fields(jax_config.Options)}
    assert port == ref
    assert config._CSV_FIELDS == jax_config._CSV_FIELDS
    for is_train in (True, False):
        flags = sorted(a.dest for a in config.build_parser(is_train)._actions)
        assert flags == sorted(a.dest for a in jax_config.build_parser(is_train)._actions)


@pytest.mark.parametrize("argv", [
    [],
    ["--label_nc", "35", "--use_instance", "--fg", "--fg_labels", "26,27",
     "--ngf", "128", "--n_scales_spatial", "3", "--gpu_ids", "-1"],
    ["--n_frames_total", "12", "--max_frames_per_gpu", "2", "--TTUR", "--no_vgg",
     "--lr", "0.0001", "--gpu_ids", "0,1", "--name", "x"],
], ids=["defaults", "label2city", "train"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_parse_args_copy_equals_the_jax_parse_args(tmp_path, argv, is_train):
    argv = argv + ["--checkpoints_dir", str(tmp_path)]
    if not is_train:
        argv = [a for a in argv if a not in ("--TTUR", "--no_vgg")]
        argv = _drop_flag(_drop_flag(argv, "--lr"), "--n_frames_total")
        argv = _drop_flag(argv, "--max_frames_per_gpu")
    got = config.parse_args(argv, is_train=is_train, save=False)
    want = jax_config.parse_args(argv, is_train=is_train, save=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _drop_flag(argv, flag):
    if flag not in argv:
        return argv
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


MAPPINGS = [
    ("composite_generator_mapping", (2, 2, "batch")),
    ("composite_generator_mapping", (3, 9, "batch", True, False)),
    ("composite_generator_mapping", (2, 3, "instance", False, True)),
    ("composite_local_mapping", (1, "batch", True, False)),
    ("composite_local_mapping", (3, "instance", False, True)),
    ("global_generator_mapping", (3, 9, "instance")),
    ("global_generator_mapping", (2, 1, "batch")),
    ("global_with_features_mapping", (3, 9, "instance")),
    ("encoder_mapping", (4, "instance")),
    ("nlayer_discriminator_mapping", (3, "batch")),
    ("multiscale_discriminator_mapping", (2, 2, "batch")),
    ("multiscale_discriminator_mapping", (3, 3, "instance")),
    ("flownet_c_mapping", ("flownetc",)),
    ("flownet_s_mapping", ("flownets_1",)),
    ("flownet_sd_mapping", ("flownets_d",)),
    ("flownet_fusion_mapping", ("flownetfusion",)),
    ("flownet2_mapping", ()),
    ("vgg19_mapping", ()),
]


@pytest.mark.parametrize("name,args", MAPPINGS, ids=[f"{n}{a}" for n, a in MAPPINGS])
def test_mapping_copies_equal_the_jax_mappings(name, args):
    assert getattr(mappings, name)(*args) == getattr(torch_import, name)(*args)


def test_convert_tensor_copy_equals_the_jax_one(rng):
    for kind, shape in (("conv", (5, 4, 3, 3)), ("convT", (4, 5, 3, 3)), ("bias", (5,))):
        arr = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            mappings.convert_tensor(arr, kind), torch_import.convert_tensor(arr, kind))


# --------------------------------------------------------- the card by default


def test_entry_points_without_a_card_raise(tmp_path, monkeypatch):
    """Without a CUDA device and without the caller asking for the CPU,
    InferenceEngine (whose generate_clip_raw and step run on its device),
    FlowHarness, Trainer and the CLIs (the flow-net CLI in inference and in
    training mode) raise."""
    from vid2vid_tpu_torch import test_cli, train_cli
    from vid2vid_tpu_torch.models.flownet2 import main_cli
    from vid2vid_tpu_torch.models.flownet2.harness import FlowHarness
    from vid2vid_tpu_torch.models.flownet2.nets import FlowNetC
    from vid2vid_tpu_torch.models.inference import InferenceEngine
    from vid2vid_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = config.Options(label_nc=3, ngf=4, n_downsample_G=1, n_blocks=1,
                         n_scales_spatial=1, ndf=4, num_D=1, n_layers_D=1, no_vgg=True)
    for build_entry in (
        lambda: InferenceEngine(opt.replace(isTrain=False)),
        lambda: Trainer(opt),
        lambda: FlowHarness(FlowNetC()),
        lambda: test_cli.main(["--checkpoints_dir", str(tmp_path)]),
        lambda: train_cli.main(["--checkpoints_dir", str(tmp_path)]),
        lambda: main_cli.main(["--inference", "--model", "FlowNetC", "--save",
                               str(tmp_path / "work")]),
        lambda: main_cli.main(["--model", "FlowNetC", "--save", str(tmp_path / "work")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_entry()
    assert InferenceEngine(opt.replace(isTrain=False), device="cpu").device.type == "cpu"
    assert Trainer(opt, device="cpu").device.type == "cpu"
