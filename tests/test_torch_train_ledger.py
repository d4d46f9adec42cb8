"""tools/train_ledger.py at its CPU size (TINY, 64x64, the seeded
FlowNet2): the rows of the serialized split sum to its total, every step's
FLOPs (FlopCounterMode, and the correlation's count) are positive and the
same when a fresh trainer counts them again, the flow row counts the
correlation's FLOPs, the trainer gets its steps back, and no device number
is reported without a card."""

import pytest
import torch

from torch_parity import torch_threads
from vid2vid_tpu_torch.tools import train_ledger
from vid2vid_tpu_torch.train import loop

ROWS = (*train_ledger.STEPS, train_ledger.FLOW_ROW)


@pytest.fixture(scope="module")
def ledger():
    with torch_threads(1):
        return train_ledger.run("cpu", reps=1)


@pytest.fixture(scope="module")
def recounted():
    """FLOPs a chunk by row and dtype, counted over one clip of a fresh
    trainer (the Ledger's counting pass alone)."""
    cpu = torch.device("cpu")
    with torch_threads(1):
        trainer, state, labels, frames = train_ledger.build_trainer(cpu, remat=True)
        counter = train_ledger.Ledger(cpu)
        counter.counting = True
        with counter.installed(trainer):
            trainer.train_clip(state, labels, frames, labels)
    chunks = 2  # TINY_FRAMES 6, tG 3, chunks of 2 frames
    return {name: {str(dt).removeprefix("torch."): n / chunks / 1e12 for dt, n in row.items()}
            for name, row in counter.flops.items()}


def test_rows_sum_to_the_serialized_total(ledger):
    total = sum(ledger[name]["ms_per_iter"] for name in (*ROWS, "host+bookkeep"))
    assert total == pytest.approx(ledger["serialized_ms_per_iter"], rel=1e-9)
    assert all(ledger[name]["ms_per_iter"] > 0 for name in ROWS)
    assert ledger["host+bookkeep"]["ms_per_iter"] > 0
    assert ledger["iters"] == 2 and ledger["steady_it_s"] > 0
    assert ledger[train_ledger.FLOW_ROW]["calls_per_iter"] == 1.0


def test_flops_positive_and_equal_in_two_runs(ledger, recounted):
    for name in ROWS:
        assert ledger[name]["tflop_per_iter"] > 0, name
        assert ledger[name]["tflop_by_dtype"] == recounted[name], name
    flow = ledger[train_ledger.FLOW_ROW]["tflop_per_iter"] * 1e12
    corr = train_ledger.correlation_flops(torch.zeros(1, 1, 3, *train_ledger.TINY_HW))
    assert flow > corr > 0  # the convs (FlopCounterMode) and the correlation


def test_no_device_numbers_on_the_cpu(ledger):
    for name in ROWS:
        row = ledger[name]
        assert row["bound_ms"] is None and row["mfu_pct"] is None
        assert row["frac_of_bound"] is None
    assert ledger["device"] == "cpu"


def test_the_trainer_gets_its_steps_back(ledger, recounted):
    assert (loop.g_step, loop.d_step, loop.dt_step) == (
        train_ledger.loop.g_step, train_ledger.loop.d_step, train_ledger.loop.dt_step)
    assert all(getattr(loop, name).__module__ == "vid2vid_tpu_torch.train.steps"
               for name in train_ledger.STEPS)
