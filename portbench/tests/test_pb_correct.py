"""`correct` at a tiny size on the CPU: the sound program passes the
cells' limits, the control (the reference in float8) fails them, and a
run whose timed path is broken underneath reads not correct, once for
each fault a serving cell can have on one card."""

import time

import pytest
import torch

from portbench.run import load_module, read_json, run_cell
from vid2vid_tpu_torch.models.inference import InferenceEngine

SEED = 2**31 + 77
SOUND_STEP = InferenceEngine.step


def state_unchanged(self, labels, inst, state, use_raw_only=False):
    frame, _ = SOUND_STEP(self, labels, inst, state, use_raw_only)
    return frame, state


def answer_altered(self, labels, inst, state, use_raw_only=False):
    frame, state = SOUND_STEP(self, labels, inst, state, use_raw_only)
    frame = frame.clone()
    h, w = frame.shape[-2:]
    frame[:, 0, : h // 2, : w // 2] += 1.0
    return frame, state


def batch_half(self, labels, inst, state, use_raw_only=False):
    """The second half of the batch left out: the first half's frames and
    state in its place."""
    half = labels.shape[0] // 2
    frame, state = SOUND_STEP(self, labels[:half], inst[:half],
                              tuple(s[:half] for s in state), use_raw_only)
    return torch.cat([frame, frame]), tuple(torch.cat([s, s]) for s in state)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.stream", None), ("tiny.batch4", None),
    ("tiny.stream", state_unchanged), ("tiny.batch4", state_unchanged),
    ("tiny.stream", answer_altered), ("tiny.batch4", answer_altered),
    ("tiny.batch4", batch_half),
])
def test_a_run_reads_correct_only_when_its_timed_path_is_sound(tiny, monkeypatch, cell, fault):
    if fault is not None:
        monkeypatch.setattr(InferenceEngine, "step", fault)
    result = run_cell(tiny, cell, SEED, 0.2, False, "cpu", start=time.perf_counter())
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_limits(tiny, seed):
    here = tiny / "portbench"
    cfg = read_json(here / "configs" / "tiny.json")
    mix = read_json(here / "traffic" / "stream.json")
    limits = read_json(here / "limits" / "tiny.stream.json")
    driver = load_module(here / "drivers" / "stream.py").Driver(cfg, mix, seed, "cpu")
    driver.measure(0.0)
    checks = driver.control(limits)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
