"""The data axis of the mesh (vid2vid_tpu_torch/parallel) against the JAX
package's, on the CPU: ranks are processes joined over gloo.

  - make_mesh's shape and shard_batch's rows against vid2vid_tpu.parallel
    on the 8 virtual CPU devices (tests/conftest.py);
  - batch norm synchronised over 2 ranks against one process on the whole
    batch (forward, every gradient, the running stats), within 1e-6;
  - two chunks of Trainer.train_chunk on 2 ranks (batch 1 each) against
    the JAX Trainer at batchSize 2 on its data = 2 mesh, within
    tests/torch_parity.py::losses_within's bounds, the ranks' weights equal
    bit for bit after each chunk; a face in one rank's sample only gives
    the single process's face losses; three broken ports (norms left
    unsynced, gradients summed, the face box per rank) leave the bounds;
  - train_cli --n_devices 2 --gpu_ids -1: the losses rank 0 logs against
    one process at batchSize 2 (and every rank on rank 0's rows out of
    those bounds), --continue_train on both ranks, and at batchSize 1 the
    model axis (data 1 x model 2) against one process at batchSize 1;
  - a rank that raises, and ranks past their deadline, fail the launch;
    kernels/build.py runs one nvcc build when two ranks call it at once.

Every launch has a deadline of its own (DEADLINE_S): a rank that hangs
fails its test. The ranks run tests/torch_ranks.py's entry functions and
train_cli.train_rank, so they never import JAX. The JAX Trainer compiles
in this process while the ranks train. A launch that fails fails the tests
that read it, and no other (`Outcomes`).
"""

import concurrent.futures
import functools
import math
import operator
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
import torch_ranks
from test_data import write_temporal_dataset
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.parallel import make_mesh as jax_make_mesh
from vid2vid_tpu.parallel import replicated as jax_replicated
from vid2vid_tpu.parallel import shard_batch as jax_shard_batch
from vid2vid_tpu.train.loop import Trainer as JaxTrainer
from vid2vid_tpu.train.state import create_train_state
from vid2vid_tpu.train.steps import make_d_step, make_dt_step, make_g_step
from vid2vid_tpu_torch import train_cli
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.nn.layers import BatchNorm2d
from vid2vid_tpu_torch.config import parse_args
from vid2vid_tpu_torch.parallel import Mesh, launch, make_mesh, shard_batch
from vid2vid_tpu_torch.train.loop import Trainer
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict, loss_engine_state_dict

# a launch's deadline: on an idle 8-core machine under `-n 6` the slowest
# launch of this file (the training CLI's two ranks) took 41 s beside the
# others and the JAX compile; the whole suite's other workers slow it more
DEADLINE_S = 240.0
# the JAX side's compile dominates this file: one residual block, one D scale,
# no VGG (VGG is held to JAX in tests/test_torch_train.py)
SMALL = dict(no_vgg=True, num_D=1, n_blocks=1)
FACE = dict(add_face_disc=True, fineSize=64, no_vgg=True)
FACE_KEYS = ("G_f_GAN", "G_f_GAN_Feat", "D_f_real", "D_f_fake")
BROKEN = ("unsynced_norms", "summed_gradients")


def _launch(fn, world=2):
    return launch(fn, world, deadline_s=DEADLINE_S, threads=1)


# ------------------------------------------------------- mesh and shards


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8])
def test_make_mesh_shape_matches_jax(batch, n):
    """The JAX Trainer's rule, make_mesh(n, data=gcd(batchSize, n))."""
    data = math.gcd(batch, n)
    assert make_mesh(n, data=data).shape == dict(jax_make_mesh(n, data=data).shape)


def test_make_mesh_refuses_an_uneven_split():
    with pytest.raises(AssertionError):
        jax_make_mesh(8, data=3)
    with pytest.raises(AssertionError):
        make_mesh(8, data=3)


@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (8, 1), (2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("batch_axis", [0, None])
def test_shard_batch_rows_match_jax(data, model, batch_axis):
    """Each rank's rows are the addressable shard of its device, rank r at
    (r // model, r % model) of JAX's (data, model) device array; with no
    batch axis every device holds the whole batch."""
    n = data * model
    x = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
    jmesh = jax_make_mesh(n, data=data)
    devices = np.asarray(jmesh.devices)
    shards = jax_shard_batch(jnp.asarray(x), jmesh, batch_axis=batch_axis).addressable_shards
    assert len(shards) == n
    for shard in shards:
        (d, m), = np.argwhere(devices == shard.device)
        got = shard_batch(torch.from_numpy(x), Mesh(data, model, d * model + m, n), batch_axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


# ------------------------------------------------------- the 2-rank runs


def _clip(batch: int = 2, n_chunks: int = 2, seed: int = 11):
    rng = np.random.default_rng(seed)
    n_total = n_chunks * tp.N_LOAD + tp.TG - 1
    labels = rng.integers(0, tp.LABEL_NC, (batch, n_total, tp.H, tp.W)).astype(np.int32)
    real = rng.uniform(-1, 1, (batch, n_total, 3, tp.H, tp.W)).astype(np.float32)
    return labels, real


def _face_clip():
    """One chunk whose face (label 2: channel 2 of the one-hot conditioning,
    which face_region reads) lies in the second sample only."""
    labels, real = _clip(n_chunks=1, seed=3)
    labels[0][labels[0] == 2] = 3
    return labels, real


def _norm_inputs():
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((4, 5, 6, 7)) + 1.0).astype(np.float32)
    w, b = rng.standard_normal(5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    return x, w, b, rng.standard_normal(x.shape).astype(np.float32)


class Outcomes(dict):
    """The fixture's results by name; one whose computation raised holds
    the exception, which reading it raises, in the tests that read it."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, BaseException):
            raise value
        return value


def _outcome(fn, *args, **kwargs):
    """fn(*args, **kwargs), or the exception it raised (a pytest failure
    included)."""
    try:
        return fn(*args, **kwargs)
    except (Exception, pytest.fail.Exception) as err:
        return err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of this file, and the single-process references, in
    threads while the JAX Trainer (batch 2, n_devices 2: data 2 x model 1)
    trains two chunks here from the same weights: one 2-rank launch of
    torch_ranks.run_all for the Trainer and batch-norm cases, the training
    CLI's three (train, --continue_train, and train with every rank on rank
    0's rows) and two failing ones; then the CLI's fourth (train at batch 1
    on the model axis) and its one-process reference."""
    root = tmp_path_factory.mktemp("cli")
    write_temporal_dataset(str(root), n_seqs=2, n_frames=6)  # 4 frames + tG - 1
    _noise_frames(root)
    with tp.torch_threads(1):
        trainer, state = _jax_trainer()
        assert trainer.mesh.shape == {"data": 2, "model": 1}
        opt = Options(**{**tp.CONFIG, **SMALL, "batchSize": 2})
        weights = (generator_state_dict(state.gparams, opt),
                   loss_engine_state_dict(state.dparams, opt))
        cfg = {**tp.CONFIG, **SMALL, "batchSize": 2, "n_devices": 2}
        face_cfg = {**tp.CONFIG, **FACE, "batchSize": 2, "n_devices": 2}
        labels, real = _clip()
        one = tuple(a[:, : tp.N_LOAD + tp.TG - 1] for a in (labels, real))
        kw = dict(n_load=tp.N_LOAD, weights=weights)
        calls = [("batch_norm_rows", _norm_inputs(), dict(update_stats=u)) for u in (False, True)]
        calls += [("train_chunks", (cfg, labels, real), kw)]
        calls += [("train_chunks", (cfg, *one), dict(kw, fault=f)) for f in BROKEN]
        calls += [("train_chunks", (face_cfg, *_face_clip()), dict(n_load=tp.N_LOAD, fault=f))
                  for f in (None, "face_box_per_rank")]
        calls += [("loaded_packages", (), {})]

        def cli():
            first = train_cli.main(_cli_flags(root, 2))
            run = root / "ckpt" / "ddp2"
            saved = (_checkpoint(run), sorted(p.name for p in run.iterdir()),
                     _scalars(run))
            resumed = train_cli.main(_cli_flags(root, 2, "--continue_train"))
            return first, saved, resumed

        def cli_model_axis():
            flags = _cli_flags(root, 2, name="model2", batch=1)
            ranks = train_cli.main(flags)
            one = root / "ckpt" / "model1"
            train_cli.main(_cli_flags(root, 1, name="model1", batch=1))
            return (ranks, _checkpoint(root / "ckpt" / "model2"), _scalars(root / "ckpt" / "model2"),
                    _checkpoint(one), _scalars(one))

        def cli_fault():
            opt = parse_args(_cli_flags(root, 2, name="ddp2_rank0_rows"), is_train=True)
            launch(torch_ranks.train_cli_rank, 2, args=(opt, "rank0_rows"),
                   devices=["cpu"] * 2, deadline_s=DEADLINE_S, threads=1)
            return _scalars(root / "ckpt" / "ddp2_rank0_rows")

        # train_cli.main launches its ranks with this file's deadline too
        with pytest.MonkeyPatch.context() as mp, \
                concurrent.futures.ThreadPoolExecutor(7) as pool:
            mp.setattr(train_cli, "launch", functools.partial(launch, deadline_s=DEADLINE_S))
            ranks = pool.submit(_launch, functools.partial(torch_ranks.run_all, calls))
            cli_ranks = pool.submit(cli)
            cli_broken = pool.submit(cli_fault)
            # a rank that raises, and a rank that outlives a short deadline
            failed = pool.submit(_failure, functools.partial(operator.truediv, 1, 0))
            hung = pool.submit(_failure, functools.partial(time.sleep, 300), 5.0)
            face_one = pool.submit(torch_ranks.train_chunks, {**face_cfg, "n_devices": 1},
                                   *_face_clip(), n_load=tp.N_LOAD)
            cli_one = pool.submit(train_cli.main, _cli_flags(root, 1))
            out = Outcomes(want=_outcome(_jax_chunks, trainer, state, labels, real), root=root)
            for name, fut in (("face_one", face_one), ("ranks", ranks), ("cli_ranks", cli_ranks),
                              ("cli_broken", cli_broken), ("failed", failed), ("hung", hung)):
                out[name] = _outcome(fut.result)
            out["cli_one"] = _outcome(lambda: cli_one.result()[0])
            # the model axis's CLI runs alone after the others: each launch
            # keeps this file's deadline on a machine the other test files share
            out["cli_model"] = _outcome(cli_model_axis)
    return out


def _noise_frames(root, seed: int = 0) -> None:
    """write_temporal_dataset's labels and frames redrawn as seeded noise,
    file for file. Its frames are flat: every norm then sees constant
    channels, normalised to 0 give or take a rounding, and the G gradient
    follows the roundings (one process alone moved its grad norm past the
    chunk-1 bound between two batch-norm formulas), so no bound would tell
    a fault from them."""
    rng = np.random.default_rng(seed)
    for sub, levels in (("train_A", 5), ("train_B", 256)):
        for path in sorted((root / sub).rglob("*.png")):
            with Image.open(path) as im:
                mode, shape = im.mode, np.asarray(im).shape
            Image.fromarray(rng.integers(0, levels, shape).astype(np.uint8), mode).save(path)


def _draw(tree, rng, collection=None, name=None):
    """Variables for a tree of shapes from jax.eval_shape(module.init, ...),
    drawn with numpy as the JAX package initialises them and
    torch_parity.randomize perturbs them: conv kernels N(0, 0.02), norm
    scales 1 + N(0, 0.02), biases N(0, 0.05), running means N(0, 0.1) and
    variances U(0.5, 1.5)."""
    if hasattr(tree, "items"):
        return {k: _draw(v, rng, k if k in ("params", "batch_stats") else collection, k)
                for k, v in tree.items()}
    shape = tree.shape
    if collection == "batch_stats":
        return (0.1 * rng.standard_normal(shape) if name == "mean"
                else 0.5 + rng.random(shape)).astype(np.float32)
    if name == "kernel":
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return (0.05 * rng.standard_normal(shape)).astype(np.float32)


def _jax_trainer():
    """The JAX Trainer at batch 2 on its data = 2 mesh, with the state its
    init_state builds (vid2vid_tpu/train/loop.py: optimizers, the state
    replicated over the mesh, the steps) from weights drawn by `_draw`: the
    trees come from jax.eval_shape, so no init is compiled."""
    trainer = JaxTrainer(JaxOptions(**{**tp.CONFIG, **SMALL, "batchSize": 2, "n_devices": 2}),
                         flow_fn=tp.jax_stub_flow)
    key, rng = jax.random.key(0), np.random.default_rng(5)
    gparams = _draw(jax.eval_shape(lambda k: trainer.gen.init(k, 1, tp.H, tp.W), key), rng)
    dparams = _draw(jax.eval_shape(lambda k: trainer.engine.init(k, tp.H, tp.W), key), rng)
    state, (trainer.g_tx, trainer.d_tx, trainer.dt_tx) = create_train_state(
        trainer.opt, gparams, dparams)
    state = jax.device_put(state, jax_replicated(trainer.mesh))
    trainer.g_step = make_g_step(trainer.gen, trainer.engine, trainer.opt, trainer.g_tx)
    trainer.d_step = make_d_step(trainer.engine, trainer.opt, trainer.d_tx)
    trainer.dt_step = make_dt_step(trainer.engine, trainer.opt, trainer.dt_tx)
    trainer.schedule.n_frames_bp = 1
    return trainer, state


def _failure(fn, deadline_s=DEADLINE_S):
    """(launch's error message, seconds to it) for a rank that cannot
    finish."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        launch(fn, 1, deadline_s=deadline_s, threads=1)
    return str(err.value), time.monotonic() - t0


def _jax_chunks(trainer, state, labels, real):
    carry = trainer.start_clip()
    real_j = jnp.asarray(np.moveaxis(real, 2, -1))
    t_len = tp.N_LOAD + tp.TG - 1
    out = []
    for i in (0, tp.N_LOAD):
        state, carry, losses = trainer.train_chunk(
            state, carry, jnp.asarray(labels[:, i : i + t_len]), real_j[:, i : i + t_len])
        out.append({k: float(v) for k, v in losses.items()})
    return out


@pytest.mark.parametrize("update_stats", [False, True])
def test_synced_batch_norm_matches_one_process(runs, update_stats):
    """Forward, d/dinput, d/dweight and d/dbias (the ranks' shares summed),
    and the running stats (the global count's unbiased variance)."""
    ranks = [r[0 if not update_stats else 1] for r in runs["ranks"]]
    x, w, b, g = (torch.from_numpy(a) for a in _norm_inputs())
    norm = BatchNorm2d(5)
    norm.update_stats = update_stats
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    x.requires_grad_(True)
    y = norm(x)
    dx, dw, db = torch.autograd.grad(y, (x, norm.weight, norm.bias), g)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-6, atol=1e-6)
    close(torch.cat([r["y"] for r in ranks]), y.detach())
    close(torch.cat([r["dx"] for r in ranks]), dx)
    close(sum(r["dweight"] for r in ranks), dw)
    close(sum(r["dbias"] for r in ranks), db)
    for r in ranks:
        close(r["running_mean"], norm.running_mean)
        close(r["running_var"], norm.running_var)
    assert bool((norm.running_mean != 0).all()) == update_stats


def test_two_ranks_match_the_jax_data_mesh(runs):
    rank0, rank1 = (r[2] for r in runs["ranks"])
    assert tp.losses_within(rank0["losses"], runs["want"]) == []
    assert rank0["losses"] == rank1["losses"]  # all-reduced before the readback
    assert len(rank0["digests"]) == 2 and rank0["digests"] == rank1["digests"]


@pytest.mark.parametrize("fault", BROKEN)
def test_a_broken_data_axis_leaves_the_bounds(runs, fault):
    got = runs["ranks"][0][3 + BROKEN.index(fault)]["losses"]
    assert tp.losses_within(got, runs["want"][:1]) != []


def test_a_face_in_one_rank_gives_the_single_process_losses(runs):
    got = runs["ranks"][0][5]["losses"]
    want = runs["face_one"]["losses"]
    assert all(want[0][k] != 0 for k in FACE_KEYS)
    assert tp.losses_within(got, want, FACE_KEYS) == []
    per_rank = runs["ranks"][0][6]["losses"]
    assert tp.losses_within(per_rank, want, FACE_KEYS) != []


def test_a_failed_rank_fails_the_launch(runs):
    message, _ = runs["failed"]
    assert "failed" in message and "ZeroDivisionError" in message


def test_ranks_past_their_deadline_are_killed(runs):
    message, seconds = runs["hung"]
    assert "deadline of 5 s passed" in message and seconds < 30


def test_the_trainer_refuses_several_devices_without_a_group():
    """--n_devices 2 in one process never trains alone: it needs 2 ranks,
    on the data axis (batch 2) as on the model axis (batch 1)."""
    for batch in (2, 1):
        with pytest.raises(RuntimeError, match="no process group of 2 ranks"):
            Trainer(Options(**{**tp.CONFIG, "batchSize": batch, "n_devices": 2}), device="cpu")


def test_a_rank_imports_no_jax(runs):
    """The ranks run the port's entry functions: after every case above,
    neither has imported JAX, flax or the JAX package."""
    for rank in runs["ranks"]:
        loaded = set(rank[-1])
        assert "vid2vid_tpu_torch" in loaded and "torch" in loaded
        assert not loaded & {"jax", "jaxlib", "flax", "vid2vid_tpu"}


def test_one_process_builds_the_kernels(tmp_path, monkeypatch):
    """kernels/build.py::build called by two ranks at once (threads here,
    with nvcc stubbed): the first to take the build lock runs nvcc, the
    other waits for it and loads its library without nvcc."""
    import threading

    from vid2vid_tpu_torch.kernels import build

    calls = []

    def nvcc(cmds):
        calls.append(threading.current_thread().name)
        time.sleep(0.2)  # the other rank reaches the lock meanwhile
        if "-shared" in cmds[0]:
            open(cmds[0][cmds[0].index("-o") + 1], "wb").close()
        return [""] * len(cmds)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_run_all", nvcc)
    with concurrent.futures.ThreadPoolExecutor(2, thread_name_prefix="rank") as pool:
        paths = list(pool.map(lambda _: build.build(), range(2)))
    assert paths == [build.library_path()] * 2 and paths[0].exists()
    assert len(calls) == 2 and len(set(calls)) == 1  # one compile, one link


# ------------------------------------------------------- the training CLI


def _cli_flags(root, n_devices: int, *extra, name: str | None = None, batch: int = 2):
    """n_frames_load = n_devices * max_frames_per_gpu = 4 = n_frames_total in
    both runs: each epoch trains one chunk of one global batch, the same in
    both, and logs its losses (--tf_log: scalars.tsv, unrounded)."""
    return [
        "--dataroot", str(root), "--name", name or f"ddp{n_devices}",
        "--checkpoints_dir", str(root / "ckpt"), "--label_nc", "5",
        "--loadSize", "64", "--fineSize", "64", "--resize_or_crop", "scaleWidth",
        "--ngf", "8", "--ndf", "8", "--n_blocks", "1", "--n_downsample_G", "2",
        "--n_scales_spatial", "1", "--n_frames_G", "3", "--norm", "batch", "--no_flow",
        "--gpu_ids", "-1", "--batchSize", str(batch), "--n_devices", str(n_devices),
        "--n_frames_total", "4", "--max_frames_per_gpu", str(4 // n_devices),
        "--num_D", "1", "--n_layers_D", "2", "--n_frames_D", "3",
        "--n_scales_temporal", "1", "--no_vgg", "--niter", "2", "--niter_decay", "0",
        "--serial_batches", "--no_flip", "--print_freq", "1", "--tf_log", *extra,
    ]


def _checkpoint(run_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("latest_net_"):
            sd = torch.load(run_dir / name, weights_only=True)
            out.update({f"{name}:{k}": v for k, v in sd.items()})
    return out


def _scalars(run_dir) -> list[dict]:
    """The losses and grad norms rank 0 logged (scalars.tsv), a dict a
    logged step, in order."""
    rows: dict = {}
    for line in (run_dir / "scalars.tsv").read_text().splitlines():
        step, key, value = line.split("\t")
        rows.setdefault(int(step), {})[key] = float(value)
    return [rows[step] for step in sorted(rows)]


def test_train_cli_on_two_ranks(runs):
    (ranks, (ck2, files, log2), resumed), trainer = runs["cli_ranks"], runs["cli_one"]
    assert [r["epoch"] for r in ranks] == [3, 3] and trainer.schedule.epoch == 3
    assert ranks[0]["total_steps"] == trainer.schedule.total_steps == 4  # 2 epochs of 2
    assert ranks[0]["digest"] == ranks[1]["digest"]

    # one log, written by rank 0 alone; its all-reduced losses and grad
    # norms, a chunk an epoch, within the training bounds of the single
    # process's (chunk 1 from the same init, chunk 2 after one step)
    one = runs["root"] / "ckpt" / "ddp1"
    assert [f for f in files if f.endswith((".txt", ".tsv"))] == [
        "iter.txt", "loss_log.txt", "opt.txt", "scalars.tsv"]
    log1 = _scalars(one)
    assert len(log2) == len(log1) == 2
    assert tp.losses_within(log2, log1) == []
    # every rank on rank 0's rows leaves those bounds
    assert tp.losses_within(runs["cli_broken"], log1) != []
    ck1 = _checkpoint(one)
    assert ck2.keys() == ck1.keys() and len(ck2) > 0

    # --continue_train: both ranks restored `latest` and replayed the last
    # epoch from it (a rank that had not would hold other weights from then on)
    assert [r["epoch"] for r in resumed] == [3, 3]
    assert resumed[0]["digest"] == resumed[1]["digest"] != ranks[0]["digest"]


def test_train_cli_on_the_model_axis(runs):
    """--batchSize 1 --n_devices 2 is JAX's data 1 x model 2 mesh: each of
    the two ranks runs the generator on half of every frame's columns.
    Both end with the same weights, rank 0 alone writes the checkpoint,
    and its logged losses and grad norms are the one-process CLI's at
    batch 1 within the training bounds."""
    ranks, ck2, log2, ck1, log1 = runs["cli_model"]
    assert [r["epoch"] for r in ranks] == [3, 3] and ranks[0]["total_steps"] == 4  # 2 epochs of 2
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ck2.keys() == ck1.keys() and len(ck2) > 0
    assert len(log2) == len(log1) == 4
    assert tp.losses_within(log2, log1) == []
