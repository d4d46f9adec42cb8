"""spans.py on hand-built events with correlation ids (as torch 2.13's
events give them, with their activity type, and as torch 2.11's do,
without it), and span_check on the tiny stream cell on the CPU."""

import pytest
import torch

from portbench import span_check, spans, trace
from portbench.spans import INPUT, NORM, OUTSIDE, READINGS, RESBLOCK, STEP

RESPAIR = "void conv_wgmma_kernel<BF16, 3, 128, 2, true, false>(Params)"
CONV7 = "void conv_wgmma_kernel<BF16, 7, 64, 2, true, false>(Params)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, Fn>"
BATCH_NORM = "void at::native::batch_norm_transform_input_channels_last_kernel<float>"


class Event:
    """What spans.py and trace.py read of a profiler event."""

    def __init__(self, name, start, end, kind, corr=0, with_kind=True):
        self._name, self._start, self._dur, self.kind, self.corr = (
            name, start, end - start, kind, corr)
        if with_kind:
            self.activity_type = lambda: self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self.corr

    def device_type(self):
        on_device = self.kind in trace.DEVICE_KINDS
        return torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.kind == "user_annotation"


def window_events(with_kind=True, program=True, device=True):
    """A window [0, 1000] ns of one step [100, 900] holding a resblock
    [200, 400], a 7x7 conv [410, 440] and a norm [500, 600]; each device
    operation launched by the runtime call of its correlation id, one
    by no call in the events, one launched before the window and clipped
    to it; an operator shares a launch's number, as torch's own do."""
    ev = [Event(trace.WINDOW, 0, 1000, "user_annotation"),
          Event("cudaStreamSynchronize", 960, 998, "cuda_runtime", corr=9)]
    if program:
        ev += [Event(name, a, b, "user_annotation") for name, a, b in (
            (STEP, 100, 900), (RESBLOCK, 200, 400), ("v2v.nn.conv7", 410, 440), (NORM, 500, 600))]
    launches = [(-60, -50, 1, ELEMENTWISE, "kernel"), (150, 300, 350, ELEMENTWISE, "kernel"),
                (250, 360, 460, RESPAIR, "kernel"), (420, 600, 610, CONV7, "kernel"),
                (550, 470, 520, BATCH_NORM, "kernel"),
                (950, 950, 980, "Memcpy DtoH", "gpu_memcpy")]
    for corr, (at, a, b, name, kind) in enumerate(launches, start=1):
        ev.append(Event("cudaLaunchKernel" if kind == "kernel" else "cudaMemcpyAsync", at,
                        at + 5, "cuda_runtime", corr, with_kind))
        if device:
            ev.append(Event(name, a if corr > 1 else -50, b if corr > 1 else 20, kind, corr,
                            with_kind))
    if device:
        ev.append(Event("void gemm_kernel", 985, 995, "kernel", 99, with_kind))  # no launch
    ev.append(Event("aten::add", 120, 130, "cpu_op", corr=3))  # respair's number, no launch
    return [e if with_kind or e.kind != "cuda_runtime" else
            Event(e._name, e._start, e._start + e._dur, "cpu_op", e.corr, False) for e in ev]


@pytest.mark.parametrize("with_kind", [True, False], ids=["activity_type", "torch_2_11"])
def test_device_time_goes_to_the_innermost_span_of_its_launch(with_kind):
    s = spans.reduce_spans(window_events(with_kind), steps=1)
    assert s.unlaunched == 1
    assert s.self_s == pytest.approx({STEP: 50e-9, RESBLOCK: 100e-9, "v2v.nn.conv7": 10e-9,
                                      NORM: 50e-9, OUTSIDE: (20 + 30 + 10) * 1e-9})
    assert s.device_s == pytest.approx({STEP: 210e-9, RESBLOCK: 100e-9, "v2v.nn.conv7": 10e-9,
                                        NORM: 50e-9})
    busy = trace.reduce_events(window_events(with_kind), 1).busy_s
    assert sum(s.self_s.values()) == pytest.approx(busy)
    assert s.host_s == pytest.approx({STEP: 800e-9, RESBLOCK: 200e-9, "v2v.nn.conv7": 30e-9,
                                      NORM: 100e-9})
    assert s.count == {STEP: 1, RESBLOCK: 1, "v2v.nn.conv7": 1, NORM: 1}
    assert s.kernels[RESBLOCK] == {"respair (ours)": 1}
    assert s.kernels["v2v.nn.conv7"] == {"conv7 (ours)": 1}
    assert s.kernels[STEP] == {"respair (ours)": 1, "conv7 (ours)": 1, "batch norm": 1,
                               "elementwise / copy / cat": 1}
    assert s.all_kernels["elementwise / copy / cat"] == 2
    assert s.all_kernels["conv / gemm (cuDNN, cuBLAS)"] == 1


def test_idle_goes_to_the_spans_open_at_the_gap_midpoint():
    # gaps: [20, 300] (mid 160: step), [350, 360] (resblock), [460, 470]
    # (step), [520, 600] (mid 560: norm), [610, 950] (step), [980, 985] and
    # [995, 1000] (outside)
    s = spans.reduce_spans(window_events(), steps=1)
    assert s.idle_self_s == pytest.approx({STEP: (280 + 10 + 340) * 1e-9, RESBLOCK: 10e-9,
                                           NORM: 80e-9, OUTSIDE: 10e-9})
    assert s.idle_s == pytest.approx({STEP: 720e-9, RESBLOCK: 10e-9, NORM: 80e-9})


def test_nested_ranges_of_one_name_count_once():
    ev = window_events()
    ev.append(Event(RESBLOCK, 240, 380, "user_annotation"))
    s = spans.reduce_spans(ev, steps=1)
    assert s.device_s[RESBLOCK] == pytest.approx(100e-9)
    assert s.host_s[RESBLOCK] == pytest.approx(200e-9)
    assert s.count[RESBLOCK] == 2


@pytest.mark.parametrize("with_kind", [True, False], ids=["activity_type", "torch_2_11"])
def test_reduce_events_is_the_same_with_program_spans_or_without(with_kind):
    with_spans = trace.reduce_events(window_events(with_kind, program=True), 1)
    assert with_spans == trace.reduce_events(window_events(with_kind, program=False), 1)


WORK = {"respair": 50e-9, "conv7": 5e-9}


def test_each_reading_from_the_spans():
    s = spans.reduce_spans(window_events(), steps=1)
    got = {name: read(s, WORK) for name, read in READINGS.items()}
    assert got.pop("input_ms_per_step.serve") is None  # no input span
    assert got == pytest.approx({
        "host_ms_per_step.serve": 800e-6, "step_idle_ms.serve": 720e-6,
        "norm_ms_per_step.serve": 50e-6, "glue_ms_per_step.serve": 50e-6,
        "resblock_roofline": 50.0, "conv7_layer_roofline": 50.0})
    ev = window_events() + [Event(INPUT, 110, 160, "user_annotation")]
    s = spans.reduce_spans(ev, steps=1)
    got = {name: read(s, WORK) for name, read in READINGS.items()}
    assert got["input_ms_per_step.serve"] == pytest.approx(50e-6)  # the kernel launched at 150
    assert got["glue_ms_per_step.serve"] == 0.0


def test_readings_without_the_device_or_without_spans():
    host_only = spans.reduce_spans(window_events(device=False), steps=1)
    got = {name: read(host_only, WORK) for name, read in READINGS.items()}
    assert got.pop("host_ms_per_step.serve") == pytest.approx(800e-6)
    assert set(got.values()) == {None}
    no_spans = spans.reduce_spans(window_events(program=False), steps=1)
    assert {read(no_spans, WORK) for read in READINGS.values()} == {None}
    assert no_spans.self_s == pytest.approx({OUTSIDE: 270e-9})  # all of the busy time


def test_the_tiny_stream_cell_on_the_cpu_reads_the_host_ms_of_its_steps(tiny):
    result = span_check.check(tiny, "tiny.stream", 2**31 + 11, 0.3, "cpu")
    metrics = result["metrics"]
    assert metrics["host_ms_per_step.serve"] > 0
    assert metrics["frame_ms_p50"] > 0 and metrics["launches_per_step.serve"] is None
    assert result["spans"][STEP]["ranges"] == 1
    assert result["spans"][RESBLOCK]["ranges"] > 0
    assert result["enqueue_ms"]["n"] > 0 and result["traced_enqueue_ms"]["n"] == 3
