"""The dataset factory and the prefetching loader, the port of
vid2vid_tpu/data/loader.py.

`create_dataset` and `create_test_stream` dispatch on --dataset_mode like
the reference factory (reference: data/custom_dataset_data_loader.py:5-45).
The loader decodes in a background thread (PIL releases the interpreter
lock while it decodes), so host decoding overlaps the card's work.
"""

from __future__ import annotations

import queue
import random
import threading
from collections.abc import Iterator

import numpy as np


def create_dataset(opt):
    mode = opt.dataset_mode
    if mode == "temporal":
        from vid2vid_tpu_torch.data.temporal import TemporalDataset

        return TemporalDataset(opt)
    if mode == "face":
        from vid2vid_tpu_torch.data.face import FaceDataset

        return FaceDataset(opt)
    if mode == "pose":
        from vid2vid_tpu_torch.data.pose import PoseDataset

        return PoseDataset(opt)
    if mode == "test":
        from vid2vid_tpu_torch.data.test_stream import TestTemporalStream

        return TestTemporalStream(opt)
    raise ValueError(f"unknown dataset_mode {mode!r}")


def create_test_stream(opt):
    """The per-frame test feed of any dataset mode."""
    mode = opt.dataset_mode
    if mode in ("temporal", "test"):
        from vid2vid_tpu_torch.data.test_stream import TestTemporalStream

        return TestTemporalStream(opt)
    if mode == "face":
        from vid2vid_tpu_torch.data.face import FaceTestStream

        return FaceTestStream(opt)
    if mode == "pose":
        from vid2vid_tpu_torch.data.pose import PoseTestStream

        return PoseTestStream(opt)
    raise ValueError(f"no test stream for dataset_mode {mode!r}")


class PrefetchLoader:
    """Index-sampling loader with a background prefetch thread.

    Yields dict batches of `opt.batchSize` clips stacked on a leading batch
    axis (per-clip shapes must match within a batch); shuffles each epoch
    unless serial_batches, with the dataset's own random.Random
    (`dataset.rng`, so that one stream serves the shuffle and the items in
    the JAX package's order), or random.Random(opt.seed) for a dataset
    without one. A short remainder batch is yielded at the end of an epoch;
    an error while loading an item is raised in the consumer.
    """

    def __init__(self, dataset, opt, n_prefetch: int = 2):
        self.dataset = dataset
        self.opt = opt
        self.n_prefetch = max(1, n_prefetch if opt.nThreads > 0 else 1)
        self.rng = getattr(dataset, "rng", None) or random.Random(opt.seed)

    def __len__(self):
        return min(len(self.dataset), self.opt.max_dataset_size)

    def _order(self):
        idx = list(range(len(self)))
        if not self.opt.serial_batches:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        q: queue.Queue = queue.Queue(maxsize=self.n_prefetch)
        stop = threading.Event()

        def worker():
            try:
                for i in order:
                    if stop.is_set():
                        return
                    q.put(self.dataset[i])
            except Exception as exc:  # handed to the consumer, which raises it
                q.put(exc)
                return
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        bs = max(1, self.opt.batchSize)
        pending: list[dict] = []
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                if item is None:
                    if pending:
                        yield _stack_items(pending)
                    return
                pending.append(item)
                if len(pending) == bs:
                    yield _stack_items(pending)
                    pending = []
        finally:
            # let a worker blocked on a full queue see the stop and end
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def _stack_items(items: list[dict]) -> dict:
    """Stack per-clip dicts on a new batch axis (arrays), list the rest."""
    out = {}
    for k, v in items[0].items():
        if isinstance(v, np.ndarray):
            vs = [it[k] for it in items]
            shapes = {a.shape for a in vs}
            if len(shapes) > 1:
                raise ValueError(
                    f"cannot batch key {k!r}: per-clip shapes differ "
                    f"{sorted(shapes)} — use --batchSize 1 or a fixed-crop "
                    f"--resize_or_crop mode"
                )
            out[k] = np.stack(vs)
        elif v is None:
            out[k] = None
        else:
            out[k] = [it[k] for it in items] if len(items) > 1 else v
    return out
