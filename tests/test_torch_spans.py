"""The program's spans (utils/profiling.py::span) on the CPU: no
`record_function` call while no profiler records, one span per layer call
and per step under `profiling.trace`, each inside the step's, and neither
the frames, the state nor the exported step changed by them.

The generator is a tiny 3-scale label2city one (label_nc 8, instance
edges, a foreground class, ngf 8, 2 downsamples, 2 blocks, 1 local
block), in f32 at 32x64 with PyTorch's initialisation.
"""

import collections
import gzip
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from torch_parity import torch_threads
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import BatchNorm2d, DownConv2d, ReflectConv7, UpConvTranspose2d
from vid2vid_tpu_torch.tools import export
from vid2vid_tpu_torch.utils import profiling

CFG = dict(label_nc=8, use_instance=True, fg=True, fg_labels=(3,), ngf=8, n_downsample_G=2,
           n_blocks=2, n_blocks_local=1, n_scales_spatial=3, n_frames_G=3, norm="batch",
           bf16=False, isTrain=False)
H, W = 32, 64


@pytest.fixture(scope="module")
def engine():
    with torch_threads(1):
        torch.manual_seed(0)
        return InferenceEngine(Options(**CFG), device="cpu")


def _window(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, 8, (1, CFG["n_frames_G"], H, W), generator=g, dtype=torch.int32)
    return labels, torch.randint(0, 3, labels.shape, generator=g, dtype=torch.int32)


def _step(eng: InferenceEngine, state=None):
    labels, inst = _window()
    with torch_threads(1):
        return eng.step(labels, inst, state or eng.initial_state(1, H, W))


def _traced_spans(eng: InferenceEngine, tmp_path) -> list:
    """[(name, start µs, end µs)] of the program's spans in a trace of one
    step."""
    with torch_threads(1), profiling.trace(str(tmp_path), "cpu"):
        _step(eng)
    (path,) = tmp_path.rglob("*.pt.trace.json.gz")
    with gzip.open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e["name"] in profiling.SPANS]


def test_no_profiler_no_record_function(engine, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    for name in profiling.SPANS:
        assert profiling.span(name) is profiling._NO_SPAN
    frame, _ = _step(engine)  # every span of a step, none recording
    assert frame.shape == (1, 3, H, W)


def test_a_step_opens_one_span_per_layer_call_inside_its_own(engine, tmp_path):
    gen = engine.compute_generator()
    in_blocks = {id(m) for b in gen.modules() if isinstance(b, ResnetBlock)
                 for m in b.modules()}
    count = collections.Counter(type(m) for m in gen.modules() if id(m) not in in_blocks)
    spans = _traced_spans(engine, tmp_path)
    got = collections.Counter(name for name, _, _ in spans)
    assert got[profiling.STEP] == 1
    assert got[profiling.RESBLOCK] == sum(isinstance(m, ResnetBlock) for m in gen.modules()) > 0
    assert got[profiling.CONV7] == count[ReflectConv7] > 0
    assert got[profiling.NORM] == count[BatchNorm2d] > 0
    assert got[profiling.DOWN] == count[DownConv2d] > 0
    assert got[profiling.UP] == count[UpConvTranspose2d] > 0
    assert got[profiling.WARP_BLEND] == CFG["n_scales_spatial"]
    assert got[profiling.INPUT] == 3  # encode, the cast, the pyramid
    (step,) = [(a, b) for name, a, b in spans if name == profiling.STEP]
    assert all(step[0] <= a <= b <= step[1] for _, a, b in spans)


def test_frames_and_state_are_the_same_traced_or_not(engine, tmp_path):
    state = engine.initial_state(1, H, W)
    frame, new_state = _step(engine, state)
    with torch_threads(1), profiling.trace(str(tmp_path), "cpu"):
        traced_frame, traced_state = _step(engine, state)
    assert torch.equal(frame, traced_frame)
    assert all(torch.equal(a, b) for a, b in zip(new_state, traced_state, strict=True))


def test_the_exported_step_holds_no_profiler_operator(engine):
    with torch_threads(1):
        program, _ = export.build_exported(Options(**CFG), engine, 1, H, W)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
