"""utils/profiling.py on the CPU: a trace that summarize_trace reads, the
kernel families on a hand-written trace, StepTimer's window, and no card's
memory stats."""

import gzip
import json
import os

import torch

from torch_parity import torch_threads
from vid2vid_tpu_torch.utils import profiling


def test_trace_on_cpu_writes_a_trace_summarize_reads(tmp_path):
    with torch_threads(1), profiling.trace(str(tmp_path), "cpu"):
        torch.randn(32, 32) @ torch.randn(32, 32)
    traces = list(tmp_path.rglob("*.pt.trace.json.gz"))
    assert len(traces) == 1
    with gzip.open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::mm" in names
    assert profiling.summarize_trace(str(tmp_path)) == []  # no device kernels on the CPU


def _event(name, dur_us, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur_us}


def test_summarize_groups_kernels_by_family(tmp_path):
    events = [
        _event("void conv_wgmma_kernel<BF16, 3, 128, 2, true, false>(Params)", 1500),
        _event("void conv_wgmma_kernel<BF16, 3, 128, 2, true, false>(Params)", 500),
        _event("void conv_wgmma_kernel<BF16, 7, 64, 2, true, false>(Params)", 800),
        _event("void warp_kernel<__nv_bfloat16, true>(WarpArgs)", 40),
        _event("Memset (Device)", 10, cat="gpu_memset"),
        _event("void at::native::batch_norm_transform_input_kernel<float>", 900),
        _event("aten::conv2d", 5000, cat="cpu_op"),  # a host op: not a kernel
        _event("Memcpy HtoD (Pageable -> Device)", 70, cat="gpu_memcpy"),
    ]
    older = tmp_path / "a.pt.trace.json.gz"
    with gzip.open(older, "wt") as fh:
        json.dump({"traceEvents": [_event("void conv_wgmma_kernel<BF16, 7,", 1)]}, fh)
    path = tmp_path / "run" / "b.pt.trace.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    older_mtime = path.stat().st_mtime - 10
    os.utime(older, (older_mtime, older_mtime))
    got = profiling.summarize_trace(str(tmp_path))
    assert got == [("respair (ours)", 2.0), ("batch norm", 0.9), ("conv7 (ours)", 0.8),
                   ("warp kernels (ours)", 0.04),
                   ("memset (the warp backward's splat, others)", 0.01)]
    assert profiling.summarize_trace(str(tmp_path), top=2) == got[:2]


def test_step_timer_keeps_its_window():
    timer = profiling.StepTimer(window=3)
    for _ in range(5):
        timer.start()
        dt = timer.stop()
        assert dt >= 0.0
    assert len(timer.times) == 3
    assert timer.mean == sum(timer.times) / 3


def test_no_card_no_memory_stats():
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
