"""Importing the port loads neither JAX nor PIL and builds no kernel, and a
CUDA-only entry without a GPU raises instead of falling back."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vid2vid_tpu_torch.ops.correlation import correlation
from vid2vid_tpu_torch.ops.respair import respair
from vid2vid_tpu_torch.ops.warp import flow_warp, warp_blend

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
for m in mods:
    importlib.import_module(m)
from vid2vid_tpu_torch.kernels import build
loaded = sorted(set(sys.modules) - before)
print(json.dumps({
    "modules": mods,
    "loaded": [m for m in loaded if m.split(".")[0] in ("jax", "jaxlib", "flax", "PIL")],
    "subprocesses": started,
    "library_loaded": build.library.cache_info().currsize,
}))
"""


def test_import_loads_no_jax_pil_or_build():
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True,
        text=True, timeout=300,
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
