"""The port's flow-net training (vid2vid_tpu_torch.models.flownet2:
FlowHarness.train_step / train_epoch / fit, the .pth.tar checkpoints, the
CLI's training mode) against the JAX package's harness, on CPU, f32; and a
numpy walk of the correlation backward kernel's gather indexing
(csrc/correlation.cu::correlation_bwd_kernel) against jax.vjp of
correlation_ref.

One FlowNetC step at (1, 2, 64, 128, 3) shares its weights (xavier-uniform
kernels drawn with numpy into flax's tree, random biases, carried into the
port with from_jax) and its numpy inputs with `jax.value_and_grad` of the
JAX harness's loss (vid2vid_tpu/models/flownet2/harness.py:52-66) and the
JAX harness's optax Adam. Torch runs on one intra-op thread
(torch_parity.torch_threads): the nets are small and the test workers share
the machine's cores.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import init_like, nchw, nhwc, randomize, torch_threads
from vid2vid_tpu.models.flownet2.harness import FlowHarness as JaxFlowHarness
from vid2vid_tpu.models.flownet2.losses import multiscale_flow_loss
from vid2vid_tpu.models.flownet2.nets import FlowNetC as JaxFlowNetC
from vid2vid_tpu.ops.correlation import correlation_ref
from vid2vid_tpu_torch.models.flownet2 import flow_io
from vid2vid_tpu_torch.models.flownet2.harness import FlowHarness
from vid2vid_tpu_torch.models.flownet2.main_cli import main
from vid2vid_tpu_torch.models.flownet2.nets import FlowNetC, FlowNetS, init_flownet_weights
from vid2vid_tpu_torch.ops import correlation as corr
from vid2vid_tpu_torch.utils.from_jax import flownet_state_dict

DIV_FLOW, LR = 0.05, 1e-4
PAIR_SHAPE = (1, 2, 64, 128, 3)


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _sample(seed=0, shape=PAIR_SHAPE):
    """A numpy frame pair in [0, 1) and a flow of a few pixels."""
    rng = np.random.default_rng(seed)
    pair = rng.random(shape, dtype=np.float32)
    flow = (3.0 * rng.standard_normal(shape[:1] + shape[2:4] + (2,))).astype(np.float32)
    return pair, flow


@pytest.fixture(scope="module")
def jax_step():
    """(variables, loss, err, grads, the variables after the Adam step) of
    one JAX harness step of FlowNetC on `_sample()`."""
    ref = JaxFlowHarness(JaxFlowNetC(train_outputs=True), lr=LR, div_flow=DIV_FLOW)
    shapes = jax.eval_shape(ref.net.init, jax.random.key(0), jnp.zeros((1, 64, 64, 6)))
    rng = np.random.default_rng(0)
    variables = randomize(init_like(shapes, rng, xavier=True), rng)
    pair, flow = _sample()
    x = jnp.concatenate([pair[:, 0], pair[:, 1]], -1)

    def loss_fn(p):  # the JAX harness's, at compute dtype f32
        flows = ref.net.apply(p, x)
        flows = [f.astype(jnp.float32) for f in flows]
        return multiscale_flow_loss(flows, jnp.asarray(flow), ref.div_flow)

    (loss, err), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    updates, _ = ref.tx.update(grads, ref.tx.init(variables), variables)
    return variables, float(loss), float(err), grads, optax.apply_updates(variables, updates)


def _port_harness(variables, **kwargs):
    net = FlowNetC(train_outputs=True)
    net.load_state_dict(flownet_state_dict(variables, "FlowNetC"), strict=True)
    return FlowHarness(net, lr=LR, div_flow=DIV_FLOW, device="cpu", **kwargs)


def test_train_step_matches_jax_loss_and_gradients(jax_step):
    """Loss and EPE within 1e-5 relative; each parameter's gradient within
    1e-4 relative in L2 (f32 sums in another order through 20 convs and
    the 441-tap correlation); then Adam's step: within 1e-6 where
    |g| > 1e-3 max|g| of its tensor (the first step moves a weight by
    ~lr * sign(g) wherever |g| >> eps, so a gradient near zero whose sign
    differs between the two would move it the other way)."""
    variables, loss, err, grads, updated = jax_step
    harness = _port_harness(variables)
    got_loss, got_err = harness.train_step(*_sample())
    assert loss > 1e-2 and err > 1.0
    assert float(got_loss) == pytest.approx(loss, rel=1e-5)
    assert float(got_err) == pytest.approx(err, rel=1e-5)
    want_grads = flownet_state_dict(grads, "FlowNetC")
    want_after = flownet_state_dict(updated, "FlowNetC")
    params = dict(harness.net.named_parameters())
    assert sorted(params) == sorted(want_grads)
    for name, p in params.items():
        g, want = p.grad, want_grads[name]
        assert float(want.norm()) > 0, name
        rel = float((g - want).norm() / want.norm())
        assert rel <= 1e-4, f"{name}: relative L2 {rel:.3g}"
        big = want.abs() > 1e-3 * want.abs().max()
        step = (p.detach() - want_after[name]).abs()[big]
        assert float(step.max()) <= 1e-6, f"{name}: {float(step.max()):.3g}"
        assert p.dtype == torch.float32


def test_steps_lower_the_epe_on_a_constant_flow(jax_step):
    """Four steps of FlowNetC on one pair with a constant 2-pixel flow."""
    harness = _port_harness(jax_step[0])
    pair, _ = _sample(1)
    flow = np.full(PAIR_SHAPE[:1] + PAIR_SHAPE[2:4] + (2,), 2.0, np.float32)
    errs = [float(harness.train_step(pair, flow)[1]) for _ in range(4)]
    assert errs[-1] < errs[0], errs


def test_mixed_precision_step_keeps_f32_masters(jax_step):
    """--fp16: the forward on a bf16 copy, the f32 masters updated. Its loss
    is within 5e-2 relative of the f32 step's on the same weights and
    inputs: bf16 keeps 8 significant bits (2**-9 of each value a rounding),
    and the roundings of ~20 layers and the correlation's operands add up
    to ~1e-2 at most on these random weights."""
    f32 = _port_harness(jax_step[0])
    bf16 = _port_harness(jax_step[0], mixed_precision=True)
    want, _ = f32.train_step(*_sample())
    loss, err = bf16.train_step(*_sample())
    assert math.isfinite(float(loss)) and math.isfinite(float(err))
    assert float(loss) == pytest.approx(float(want), rel=5e-2)
    for name, p in bf16.net.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    moved = [not torch.equal(p, q) for p, q in zip(bf16.net.parameters(),
                                                   _port_harness(jax_step[0]).net.parameters())]
    assert all(moved)


class _ConstantFlow:
    """Two (pair (2, 64, 64, 3), constant flow) samples from numpy."""

    def __len__(self):
        return 2

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return (r.standard_normal((2, 64, 64, 3)).astype(np.float32),
                np.full((64, 64, 2), 2.0, np.float32))


def _flownet_s(seed=0):
    net = FlowNetS(input_channels=6, train_outputs=True)
    init_flownet_weights(net, torch.Generator().manual_seed(seed))
    return net


def _optimizer_tensors(harness):
    return [t for s in harness.optimizer.state_dict()["state"].values()
            for t in s.values()]


def test_fit_tracks_best_and_restores(tmp_path, capsys):
    """As the JAX package's TestBestEpeCheckpointing: fit over two epochs
    saves both files; restoring `best` into a fresh harness brings back the
    best file's weights and Adam state bit for bit and validates to the
    tracked best; `latest` equals the live harness."""
    harness = FlowHarness(_flownet_s(), lr=1e-4, device="cpu")
    best = harness.fit(_ConstantFlow(), _ConstantFlow(), n_epochs=2, save_dir=str(tmp_path),
                       prefix="t")
    out = capsys.readouterr().out
    assert "epoch 1/2: train EPE" in out and "(best)" in out
    assert np.isfinite(best)
    latest, best_file = (tmp_path / "t_checkpoint.pth.tar", tmp_path / "t_model_best.pth.tar")
    assert latest.is_file() and best_file.is_file()
    payload = torch.load(str(best_file), weights_only=True)
    assert payload["arch"] == "FlowNetS" and payload["best_EPE"] == best

    fresh = FlowHarness(_flownet_s(seed=1), lr=1e-4, device="cpu")
    epoch, best2 = fresh.restore_checkpoint(str(tmp_path), prefix="t", best=True)
    assert epoch == payload["epoch"] >= 1 and best2 == best
    for k, v in fresh.net.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    saved = [t for s in payload["optimizer"]["state"].values() for t in s.values()]
    assert all(torch.equal(a, b) for a, b in zip(_optimizer_tensors(fresh), saved))
    assert fresh.validate(_ConstantFlow()) == pytest.approx(best2, rel=1e-3)

    again = FlowHarness(_flownet_s(seed=2), lr=1e-4, device="cpu")
    assert again.restore_checkpoint(str(tmp_path), prefix="t") == (2, best)
    for a, b in zip(again.net.state_dict().values(), harness.net.state_dict().values()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(_optimizer_tensors(again),
                                                 _optimizer_tensors(harness)))


def _chairs(root, n=2, hw=(64, 64)):
    """A FlyingChairs tree: n (img1, img2, flow) triples."""
    from PIL import Image

    r = np.random.default_rng(0)
    root.mkdir(parents=True)
    for i in range(n):
        for tag in ("img1", "img2"):
            Image.fromarray(r.integers(0, 255, hw + (3,), np.uint8), "RGB").save(
                str(root / f"{i:05d}_{tag}.ppm"))
        flow_io.write_flo(str(root / f"{i:05d}_flow.flo"), np.ones(hw + (2,), np.float32))
    return root


def test_cli_trains_saves_and_resumes_best(tmp_path, capsys):
    """As the JAX package's TestMainCli: the reflection flags reach the
    dataset classes, an epoch trains and saves both files; a second run
    resumes `best` and trains on."""
    data = _chairs(tmp_path / "chairs")
    argv = ["--model", "FlowNetS", "--training_dataset", "FlyingChairs",
            "--training_dataset_root", str(data), "--validation_dataset", "FlyingChairs",
            "--validation_dataset_root", str(data), "--total_epochs", "1",
            "--save", str(tmp_path / "work"), "--name", "smoke", "--device", "cpu",
            "--log_frequency", "1"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "train: 2 pairs, val: 2 pairs" in out and "[2/2] EPE" in out
    assert "best val EPE:" in out
    for tag in ("checkpoint", "model_best"):
        assert (tmp_path / "work" / f"smoke_{tag}.pth.tar").is_file()
    assert main(argv + ["--resume", "best"]) == 0
    assert "resumed best (epoch 1, best EPE" in capsys.readouterr().out


# ------------------------------------------- the backward kernel's indexing

# (B, C, H, W): C not a multiple of BWD_CHUNK and below it, H not a multiple
# of BWD_TILE_Y, W not a multiple of BWD_TILE_X, images smaller than the
# displacement, and two channel chunks of a batch of two
WALK_SHAPES = [(1, 17, 13, 70), (2, 9, 22, 41), (2, 32, 5, 9)]


def _walk_bwd(f1, f2, g):
    """(df1, df2, writes) as csrc/correlation.cu::correlation_bwd_kernel
    indexes them: its grid (`correlation_bwd_grid`), each thread's pixel
    and channel chunk, the flat offsets of every g / f read and of every
    store, and the in-image tests; f64 sums."""
    b_, c_, h, w = f1.shape
    tx, ty, cc_n = corr.BWD_TILE_X, corr.BWD_TILE_Y, corr.BWD_CHUNK
    rad = corr.KERNEL_RADIUS
    nd = 2 * rad + 1
    hw = h * w
    f1f, f2f, gf = (a.astype(np.float64).ravel() for a in (f1, f2, g))
    df1, df2 = np.full(f1.size, np.nan), np.full(f1.size, np.nan)
    writes = np.zeros(f1.size, np.int64)
    gx, gy, gz = corr.correlation_bwd_grid(b_, c_, h, w)
    chunks = -(-c_ // cc_n)
    tyy, txx = np.meshgrid(np.arange(ty), np.arange(tx), indexing="ij")
    for bz in range(gz):
        b = bz // chunks
        c0 = (bz - b * chunks) * cc_n
        nc = min(cc_n, c_ - c0)
        chan = np.arange(nc)[:, None] * hw
        base = (b * c_ + c0) * hw
        for by in range(gy):
            for bx in range(gx):
                x, y = (bx * tx + txx).ravel(), (by * ty + tyy).ravel()
                live = (x < w) & (y < h)
                x, y = x[live], y[live]
                a1, a2 = np.zeros((nc, x.size)), np.zeros((nc, x.size))
                for j in range(nd):
                    dy = 2 * (j - rad)
                    y1, y2 = y + dy, y - dy
                    row1, row2 = (y1 >= 0) & (y1 < h), (y2 >= 0) & (y2 < h)
                    for i in range(nd):
                        dx = 2 * (i - rad)
                        x1, x2 = x + dx, x - dx
                        gd = b * nd * nd * hw + (j * nd + i) * hw
                        m1 = row1 & (x1 >= 0) & (x1 < w)
                        gv = gf[gd + y[m1] * w + x[m1]]
                        a1[:, m1] += gv * f2f[base + chan + y1[m1] * w + x1[m1]]
                        m2 = row2 & (x2 >= 0) & (x2 < w)
                        o = y2[m2] * w + x2[m2]
                        a2[:, m2] += gf[gd + o] * f1f[base + chan + o]
                at = base + chan + y * w + x
                df1[at], df2[at] = a1 / c_, a2 / c_
                np.add.at(writes, at.ravel(), 1)
    return df1.reshape(f1.shape), df2.reshape(f1.shape), writes.reshape(f1.shape)


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=["x".join(map(str, s)) for s in WALK_SHAPES])
def test_correlation_backward_walk_matches_jax_vjp(shape):
    """Every gradient element is stored exactly once, and the gather sums
    (in f64) equal jax.vjp of correlation_ref within 1e-5: JAX sums up to
    441 products of O(1) in f32 (~2e-6 off at C = 9), where a wrong tap or
    store is off by O(0.1)."""
    rng = np.random.default_rng(sum(shape))
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    b, c, h, w = shape
    g = rng.standard_normal((b, 441, h, w)).astype(np.float32)
    df1, df2, writes = _walk_bwd(f1, f2, g)
    assert (writes == 1).all()
    _, vjp = jax.vjp(correlation_ref, jnp.asarray(nhwc(torch.from_numpy(f1))),
                     jnp.asarray(nhwc(torch.from_numpy(f2))))
    want = vjp(jnp.asarray(nhwc(torch.from_numpy(g))))
    for got, ref in zip((df1, df2), want):
        ref = nchw(ref).numpy()
        assert np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the port's CPU path (the plain version's autograd) agrees too
    plain = corr.correlation_bwd(*(torch.from_numpy(a) for a in (f1, f2, g)))
    for got, ref in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), nchw(ref).numpy(), atol=1e-5, rtol=1e-5)
