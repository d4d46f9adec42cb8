"""The yardstick's arithmetic: operations and bytes against hand counts,
a step's count from the reference, the rates over the whole window, the
tail over every step, and the reduction of a trace."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import trace, work
from portbench.reference.vid2vid import Vid2VidReference
from portbench.run import load_module

REPO = Path(__file__).resolve().parents[2]
METRICS = REPO / "portbench" / "metrics"


def test_respair_work_by_hand():
    # ResnetBlock at C = 1024 on the 32 x 64 trunk, bf16: two 3x3 convs of
    # 2 * 2048 px * 1024 * 1024 * 9 operations; x and y of 1024 * 2048 * 2
    # bytes, two weights of 9 * 1024^2 * 2, two f32 (scale, shift) pairs
    assert work.respair_work(1, 1024, 32, 64, 2) == (77_309_411_328, 46_153_728)


def test_conv7_work_by_hand():
    # the label stem at 256 x 512: 108 -> 128 channels, 131072 px, 49 taps;
    # in 108 and out 128 channels of 2 bytes a pixel, the weight, f32 bias
    assert work.conv7_work(1, 108, 128, 256, 512, 2) == (177_570_054_144, 63_221_248)


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert work.bound_s(989e12, 0.0, torch.bfloat16) == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12, torch.bfloat16) == pytest.approx(1.0)
    assert work.bound_s(165e12, 0.0, torch.float32) == pytest.approx(1.0)


def test_the_flagship_step_counts_from_the_reference():
    cfg = json.loads((REPO / "portbench/configs/label2city_2048.json").read_text())
    with torch.device("meta"):
        ref = Vid2VidReference(cfg["options"])
    labels = torch.zeros((1, 3, 1024, 2048), dtype=torch.int64, device="meta")
    state = ref.zero_state(1, 1024, 2048, "meta")
    counted = work.count_step(ref, lambda: ref.step(labels, labels, state), torch.bfloat16)
    # 45 ResnetBlocks and 21 7x7 convs a frame; the kernel table's bounds
    # (respair 2.638 ms, conv7 2.23 summed per conv)
    assert counted["respair"] * 1e3 == pytest.approx(2.6397, abs=1e-3)
    assert counted["conv7"] * 1e3 == pytest.approx(2.2255, abs=1e-3)
    assert counted["flops"] == pytest.approx(5.0639e12, rel=1e-4)


def _read(name, run):
    return load_module(METRICS / f"{name}.py").read(run)


def test_rates_take_the_whole_window_and_the_tail_every_step():
    steps = [0.001 * (i + 1) for i in range(100)]  # 1 .. 100 ms
    window = SimpleNamespace(step_s=steps, frames=400, window_s=10.0)
    run = SimpleNamespace(window=window, setup_s=3.0, dtype=torch.bfloat16,
                          work={"flops": 989e12 * 0.01})
    assert _read("frames_per_s", run) == 40.0  # frames over the window, not over the steps' sum
    assert _read("frame_ms_p95", run) == pytest.approx(95.05)
    assert _read("frame_ms_p95", run) == pytest.approx(np.percentile(steps, 95) * 1e3)
    assert _read("frame_ms_p50", run) == pytest.approx(50.5)
    assert _read("mfu.serve", run) == pytest.approx(10.0)  # 10 ms of bound a 100 ms step


class Event:
    """A profiler event as torch 2.11 gives it (no activity_type)."""

    def __init__(self, name, device, start, dur, annotation=False):
        self._n, self._d, self._s, self._t, self._a = name, device, start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_a_trace_reduces_to_busy_time_families_and_idle_by_host_op():
    events = [
        Event(trace.WINDOW, False, 0, 100, annotation=True),
        Event(trace.WINDOW, True, 5, 90, annotation=True),
        Event("aten::foo", False, 0, 40), Event("aten::bar", False, 35, 10),
        Event("void conv_wgmma_kernel<bf16, 3, 64, 2, true, 1>", True, 10, 10),
        Event("void conv7x7_kernel<float>", True, 15, 15),
        Event("Memcpy DtoH (Device -> Pageable)", True, 50, 10),
        Event("void late_kernel", True, 150, 10),
    ]
    t = trace.reduce_events(events, steps=2)
    assert (t.window_s, t.busy_s, t.kernels) == (100e-9, 30e-9, 2)
    assert t.families == pytest.approx({"respair (ours)": 10e-9, "conv7 (ours)": 15e-9,
                                        "memcpy": 10e-9})
    assert t.idle_by_host_op == pytest.approx(
        {"aten::foo": 10e-9, "aten::bar": 20e-9, "(host between operators)": 40e-9})
    run = SimpleNamespace(trace=t, work={"respair": 2e-9, "conv7": 3e-9})
    assert _read("respair_roofline", run) == pytest.approx(40.0)
    assert _read("conv7_roofline", run) == pytest.approx(40.0)
    assert _read("idle_share.serve", run) == pytest.approx(70.0)
    assert _read("launches_per_step.serve", run) == 1.0
    run.trace.families = {}
    assert _read("respair_roofline", run) is None
