"""The port's training data (data/files.py, transforms.py, temporal.py,
loader.py) and its test stream against the JAX package's, on trees written
by tests/test_data.py::write_temporal_dataset.

The JAX package draws from the global `random` and `np.random`; the port
from the dataset's own generators, seeded with opt.seed. Seeded the same,
the two give the same items, bit for bit, and the same shuffled order.
"""

import contextlib
import os
import random
import threading

import numpy as np
import pytest
from PIL import Image

from test_data import write_temporal_dataset
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.data import files as jax_files
from vid2vid_tpu.data.loader import PrefetchLoader as JaxLoader
from vid2vid_tpu.data.loader import create_dataset as jax_create_dataset
from vid2vid_tpu.data.temporal import TestTemporalStream as JaxTestStream
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data import files, temporal
from vid2vid_tpu_torch.data.loader import PrefetchLoader, create_dataset
from vid2vid_tpu_torch.data.test_stream import TestTemporalStream

SEED = 3


@contextlib.contextmanager
def jax_globals(seed: int):
    """The global generators the JAX package draws from, seeded; restored after."""
    saved = random.getstate(), np.random.get_state()
    random.seed(seed)
    np.random.seed(seed)
    try:
        yield
    finally:
        random.setstate(saved[0])
        np.random.set_state(saved[1])


def textured_tree(root, n_seqs=3, n_frames=8, size=(96, 64)):
    """write_temporal_dataset's tree with a pattern added to every image,
    so that crops and flips show in the pixels."""
    write_temporal_dataset(str(root), n_seqs=n_seqs, n_frames=n_frames, size=size)
    w, h = size
    pattern = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None]) % 31
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            arr = np.asarray(Image.open(path)).astype(np.int32)
            if arr.ndim == 3:
                arr = arr + (pattern * 7)[..., None] + np.array([0, 40, 80])
            else:
                arr = arr + (pattern % 5 if "train_A" in path else pattern % 3)
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(path)


def options(root, **kw):
    base = dict(dataroot=str(root), label_nc=8, use_instance=True, n_frames_total=4,
                max_frames_per_gpu=2, loadSize=96, fineSize=64, n_frames_G=3,
                max_t_step=2, seed=SEED)
    base.update(kw)
    return JaxOptions(**base), Options(**base)


def assert_items_equal(port: dict, want: dict):
    """A port item (NCHW) equals a JAX item (NHWC), bit for bit."""
    np.testing.assert_array_equal(port["A"], want["A"])
    assert port["A"].dtype == want["A"].dtype == np.int32
    np.testing.assert_array_equal(port["B"], np.moveaxis(want["B"], -1, -3))
    assert port["B"].dtype == np.float32 and port["B"].flags.c_contiguous
    if want["inst"] is None:
        assert port["inst"] is None
    else:
        np.testing.assert_array_equal(port["inst"], want["inst"])
    assert port["A_path"] == want["A_path"] and port["seq"] == want["seq"]


def test_grouped_scan_and_path_check_match_jax(tmp_path):
    write_temporal_dataset(str(tmp_path), n_seqs=2, n_frames=3)
    for sub in ("train_A", "train_B"):  # keypoint files count as frames
        open(tmp_path / sub / "seq000" / "00009.txt", "w").close()
    for sub in ("train_A", "train_B", "train_inst"):
        assert files.make_grouped_dataset(str(tmp_path / sub)) == \
            jax_files.make_grouped_dataset(str(tmp_path / sub))
    a = files.make_grouped_dataset(str(tmp_path / "train_A"))
    assert len(a[0]) == 4 and a[0][-1].endswith(".txt")
    files.check_path_valid(a, files.make_grouped_dataset(str(tmp_path / "train_B")))
    with pytest.raises(ValueError, match="frame count"):
        files.check_path_valid(a, files.make_grouped_dataset(str(tmp_path / "train_inst")))
    with pytest.raises(FileNotFoundError):
        files.make_grouped_dataset(str(tmp_path / "missing"))


@pytest.mark.parametrize("resize_or_crop", ["scaleWidth", "scaleWidth_and_crop"])
def test_temporal_items_match_jax(tmp_path, monkeypatch, resize_or_crop):
    """Items of several epochs' worth of indices, bit for bit, with the
    random stride and start; with the crop, the random crop and the flip
    (on: no --no_flip), each of which takes both values."""
    textured_tree(tmp_path, n_frames=12)  # long enough for a stride of 2
    jopt, popt = options(tmp_path, resize_or_crop=resize_or_crop)
    drawn = []
    get = temporal.get_img_params
    monkeypatch.setattr(temporal, "get_img_params",
                        lambda *a: drawn.append(get(*a)) or drawn[-1])
    port = create_dataset(popt)
    with jax_globals(SEED):
        want = [jax_create_dataset(jopt)[i] for i in range(8)]
    got = [port[i] for i in range(8)]
    for p, w in zip(got, want):
        assert_items_equal(p, w)
    starts = {p["A_path"] for p in got}
    assert len(starts) > 3  # the start is drawn
    if resize_or_crop == "scaleWidth":
        assert got[0]["A"].shape == (6, 64, 96)
    else:
        assert got[0]["A"].shape == (6, 64, 64)
        assert {d.flip for d in drawn} == {True, False}
        assert len({d.crop_pos for d in drawn}) > 1


def test_set_n_frames_total_matches_jax(tmp_path):
    write_temporal_dataset(str(tmp_path), n_seqs=2, n_frames=8)
    jopt, popt = options(tmp_path, resize_or_crop="scaleWidth", max_t_step=1)
    jax_ds, port = jax_create_dataset(jopt), create_dataset(popt)
    assert port.seq_len_max == jax_ds.seq_len_max == 8
    for n in (2, 4, 6, 50):
        jax_ds.set_n_frames_total(n)
        port.set_n_frames_total(n)
        assert port.n_frames_total == jax_ds.n_frames_total
        with jax_globals(SEED):
            want = jax_ds[1]
        port.rng.seed(SEED)
        port.np_rng.seed(SEED)
        assert_items_equal(port[1], want)
    assert port.n_frames_total == 6  # capped at seq_len_max - (tG - 1)


def test_loader_batches_and_order_match_jax(tmp_path):
    """Two shuffled epochs of batches of 2 (the last one short) from the
    JAX loader and the port's, whose shuffle shares the dataset's generator."""
    textured_tree(tmp_path, n_seqs=5)
    jopt, popt = options(tmp_path, resize_or_crop="scaleWidth_and_crop", batchSize=2)
    jax_loader = JaxLoader(jax_create_dataset(jopt), jopt)
    port_loader = PrefetchLoader(create_dataset(popt), popt)
    assert port_loader.rng is port_loader.dataset.rng
    with jax_globals(SEED):
        want = [b for _ in range(2) for b in jax_loader]
    got = [b for _ in range(2) for b in port_loader]
    assert [b["seq"] for b in got] == [b["seq"] for b in want]
    assert sorted(s for b in got[:3] for s in np.atleast_1d(b["seq"])) == [0, 1, 2, 3, 4]
    assert [b["seq"] for b in got[:3]] != [[0, 1], [2, 3], 4]  # shuffled
    for p, w in zip(got, want):
        assert p["A"].shape[0] == w["A"].shape[0]
        np.testing.assert_array_equal(p["A"], w["A"])
        np.testing.assert_array_equal(p["B"], np.moveaxis(w["B"], -1, -3))
        np.testing.assert_array_equal(p["inst"], w["inst"])


def test_loader_raises_a_failed_item_and_stops_its_thread(tmp_path):
    write_temporal_dataset(str(tmp_path), n_seqs=2)
    _, popt = options(tmp_path, resize_or_crop="scaleWidth", serial_batches=True)
    dataset = create_dataset(popt)
    for path in dataset.b_paths[1]:
        os.remove(path)
    threads = threading.active_count()
    with pytest.raises(FileNotFoundError):
        list(PrefetchLoader(dataset, popt))
    assert threading.active_count() == threads


def test_unported_dataset_modes_raise(tmp_path):
    """The face and pose modes are ported: they reach their datasets (which
    look for their own directories); an unknown mode still raises."""
    for mode, missing in (("face", "train_keypoints"), ("pose", "train_img")):
        with pytest.raises(FileNotFoundError, match=missing):
            create_dataset(Options(dataset_mode=mode, dataroot=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset_mode"):
        create_dataset(Options(dataset_mode="audio", dataroot=str(tmp_path)))


def test_test_stream_matches_jax(tmp_path):
    """The test stream on the ported scan and transforms: every item of the
    JAX TestTemporalStream (labels, real frames, instances, the flags and
    paths), with --start_frame on the first sequence."""
    textured_tree(tmp_path, n_seqs=2, n_frames=5)
    for sub in ("A", "B", "inst"):
        os.symlink(tmp_path / f"train_{sub}", tmp_path / f"test_{sub}")
    jopt, popt = options(tmp_path, isTrain=False, dataset_mode="test", use_real_img=True,
                         start_frame=2, resize_or_crop="scaleWidth", loadSize=64)
    want = list(JaxTestStream(jopt))
    got = list(TestTemporalStream(popt))
    assert len(got) == len(want) == 3 + 5
    for p, w in zip(got, want):
        assert p.keys() == w.keys()
        for k in ("A", "B", "inst"):
            np.testing.assert_array_equal(p[k], w[k])
            assert p[k].dtype == w[k].dtype
        assert (p["change_seq"], p["path"], p["seq"]) == (w["change_seq"], w["path"], w["seq"])
