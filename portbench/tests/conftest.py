"""Fixtures of the benchmark's own tests (CPU)."""

import os

import pytest
import torch

from portbench.tests.tiny import tiny_root


def pytest_configure(config):
    """Under pytest-xdist each worker takes its share of the cores: torch's
    threads of several workers on every core slow the runs tenfold."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A checkout of BENCHMARK.json and portbench/ with the cells at a
    tiny size on the CPU (`tiny.tiny_root`)."""
    return tiny_root(tmp_path_factory.mktemp("tiny_root"))
