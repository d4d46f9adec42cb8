"""The port's flow-net training (vid2vid_tpu_torch.models.flownet2:
FlowHarness.train_step / train_epoch / fit, the .pth.tar checkpoints, the
CLI's training mode) against the JAX package's harness, on CPU, f32; and a
numpy walk of the correlation backward kernel's tile map
(csrc/correlation.cu::correlation_bwd_kernel, mirrored by
ops/correlation.py's BWD_* constants and correlation_bwd_plan) against
jax.vjp of correlation_ref.

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


# ------------------------------------------- the backward kernel's tile map

R, MD = corr.KERNEL_RADIUS, corr.KERNEL_MAX_DISPLACEMENT
ND = 2 * R + 1
BQ, BTX, BCB, BK = corr.BWD_ROWS, corr.BWD_X, corr.BWD_CHANNELS, corr.BWD_THREAD_CHANNELS
BNT, BWIN = corr.BWD_THREADS, corr.BWD_WINDOW
BROWF, BODDF, BF_STAGE = corr.BWD_F_ROW, corr.BWD_F_ODD, corr.BWD_F_STAGE
BG_ROW = corr.BWD_G_ROW
BSTAGE = BF_STAGE + corr.BWD_G_STAGE

# (B, C, H, W): C not a multiple of the 64-channel block and below it (17,
# 9, 32) or above it (70, 65), H not a multiple of 2 * BWD_ROWS, W not a
# multiple of the 64-column tile (odd, or W % 4 != 0; W = 20 takes the
# kernel's 16-byte stores), images smaller than the displacement (5 x 9,
# 12 x 20), B = 2
WALK_SHAPES = [(1, 17, 13, 70), (2, 9, 22, 41), (2, 32, 5, 9), (1, 70, 9, 66),
               (2, 65, 12, 20)]
# the plan's coverage also at FlowNetC's training shape and chip_smoke.py's
# other timed shapes
PLAN_SHAPES = [(8, 256, 48, 64), (2, 256, 64, 128), (2, 256, 32, 64)] + WALK_SHAPES


def _lanes():
    """Each thread's warp (wx: column half, wc: channel half) and lane
    (px: column parity, pg: 4-pixel group, cg: channel group), as the
    kernel's compute map takes them from threadIdx.x."""
    t = np.arange(BNT)
    warp, lane = t >> 5, t & 31
    return t, warp & 1, warp >> 1, lane & 1, (lane >> 1) & 3, lane >> 3


def _blocks(shape):
    """Every block that has output rows, as (cb0, x0, u0, hp, par, grad,
    b), decoded from the plan's grid as the kernel does."""
    _, _, h, w = shape
    gx, gy, gz = corr.correlation_bwd_plan(*shape)
    x_tiles = -(-w // BTX)
    blocks = []
    for bz in range(gz):
        par, grad, b = bz & 1, (bz >> 1) & 1, bz >> 2
        hp = (h - par + 1) >> 1
        for by in range(gy):
            grp, xt = divmod(by, x_tiles)
            if grp * BQ >= hp:
                continue  # the block returns at once
            for bx in range(gx):
                blocks.append((bx * BCB, xt * BTX, grp * BQ, hp, par, grad, b))
    return blocks


def _stores(v, shape, cb0, x0, u0, hp, par, b):
    """The epilogue: v [thread, q, cc, e] (pixel e of the lane's parity)
    through the shuffle across parities and the masks; returns (values,
    flat (B, C, H, W) offsets) of every store, and checks that each lands
    in its own pixel's column."""
    _, c_n, h, w = shape
    t, wx, wc, px, pg, cg = _lanes()
    col = x0 + 2 * (16 * wx + 4 * pg)[:, None] + 2 * np.arange(4) + px[:, None]  # [t, e]
    xs = x0 + 32 * wx + 8 * pg + 4 * px
    out_v, out_at = [], []
    for q in range(BQ):
        u = u0 + q
        if u >= hp:
            break
        for cc in range(BK):
            val = np.stack([v[:, q, cc], np.broadcast_to(col, (BNT, 4))], -1)  # value, column
            r0 = np.where(px[:, None], val[:, 0], val[:, 2])[t ^ 1]
            r1 = np.where(px[:, None], val[:, 1], val[:, 3])[t ^ 1]
            o = np.where(px[:, None, None], np.stack([r0, val[:, 2], r1, val[:, 3]], 1),
                         np.stack([val[:, 0], r0, val[:, 1], r1], 1))  # [t, e', 2]
            c = cb0 + 32 * wc + cg + 4 * cc
            xe = xs[:, None] + np.arange(4)
            assert (o[..., 1] == xe).all(), "the shuffle put a pixel in another column"
            keep = (c < c_n)[:, None] & (xe < w)
            at = ((b * c_n + c)[:, None] * h + 2 * u + par) * w + xe
            out_v.append(o[..., 0][keep])
            out_at.append(at[keep])
    return np.concatenate(out_v), np.concatenate(out_at)


def _stage(shape, f, g, n, cb0, x0, u0, par, grad, b):
    """Stage f row n as the kernel's `stage` does: (values, and per slot
    the tap copied: kind 1 f / 2 g / 0 never written, channel or g plane,
    row, column, copied from the image (else zero-filled))."""
    _, c_n, h, w = shape
    vals = np.zeros(BSTAGE)
    kind, idx, row, col = (np.zeros(BSTAGE, np.int64) for _ in range(4))
    live = np.zeros(BSTAGE, bool)
    yf = 2 * (u0 + n - R) + par
    assert 0 <= yf < h

    def put(slot, k, i, y, x, ok, src):
        assert kind[slot].max() == 0 and len(np.unique(slot)) == len(slot)
        kind[slot], idx[slot], row[slot], col[slot], live[slot] = k, i, y, x, ok
        vals[slot[ok]] = src[i[ok], y[ok], x[ok]]

    tf = np.arange(BWIN)  # threads t < BWIN copy window column t
    xf = x0 - MD + tf
    for cl in range(BCB):
        c = cb0 + cl
        put((tf & 1) * BODDF + (tf >> 1) + cl * BROWF, 1, np.full_like(tf, c),
            np.full_like(tf, yf), xf, (xf >= 0) & (xf < w) & (c < c_n), f[b])
    t = np.arange(BNT)
    gcol, gq = t & (BTX - 1), t >> 6
    gx = x0 + gcol
    g_slot = BF_STAGE + 8 * (gcol >> 3) + 4 * (gcol & 1) + ((gcol >> 1) & 3)
    for qq in range(2):
        q = gq + 2 * qq
        for k in range(ND):
            slot = g_slot + (q * ND + k) * BG_ROW
            if grad == 0:  # g[(n - q) * 21 + k] at output row q, the tile's column
                j, y = n - q, 2 * (u0 + q) + par
                ok = (gx < w) & (j >= 0) & (j < ND) & (y < h)
                put(slot, 2, j * ND + k, y, gx, ok, g[b])
            else:  # g[(q + 20 - n) * 21 + 20 - k] at the f row, column gx - 20 + 2k
                j, xk = q + 2 * R - n, gx - MD + 2 * k
                ok = (j >= 0) & (j < ND) & (xk >= 0) & (xk < w)
                put(slot, 2, j * ND + 2 * R - k, np.full_like(t, yf), xk, ok, g[b])
    return vals, (kind, idx, row, col, live)


def _walk_bwd(f1, f2, g):
    """(df1, df2, writes per gradient and element) as csrc/correlation.cu's
    backward indexes them: the plan's grid, each block's f rows, the
    staging map (slots, parity halves, zero fill), each thread's reads of
    the staged slots (checked tap by tap against the taps its pixels,
    channels and rows need) and the stores; f64 sums."""
    shape = f1.shape
    _, c_n, h, w = shape
    blocks = _blocks(shape)
    df = np.full((2, f1.size), np.nan)
    writes = np.zeros((2, f1.size), np.int64)
    f64 = [a.astype(np.float64) for a in (f1, f2, g)]
    t, wx, wc, px, pg, cg = _lanes()
    hpix = 16 * wx + 4 * pg                                    # [t]: the lane's first pixel
    chan = 32 * wc[:, None] + cg[:, None] + 4 * np.arange(BK)  # [t, cc]
    f_read = px * BODDF + (32 * wc + cg) * BROWF + 16 * wx + 4 * pg
    g_read = BF_STAGE + 8 * (4 * wx + pg) + 4 * px
    # the reads of one f row: F [t, cc, window word m = k + e], G [t, q, k, e]
    m = np.arange(ND + 3)
    f_at = f_read[:, None, None] + (4 * np.arange(BK) * BROWF)[:, None] + m
    qk = (np.arange(BQ)[:, None] * ND + np.arange(ND)) * BG_ROW
    g_at = g_read[:, None, None, None] + qk[..., None] + np.arange(4)
    e_k = np.arange(ND)[:, None] + np.arange(4)  # [k, e]: the window word
    for cb0, x0, u0, hp, par, grad, b in blocks:
        acc = np.zeros((BNT, BQ, BK, 4))
        for n in corr.correlation_bwd_rows(u0, hp):
            vals, (kind, idx, row, col, live) = _stage(
                shape, f64[1] if grad == 0 else f64[0], f64[2], n, cb0, x0, u0, par, grad, b)
            yf = 2 * (u0 + n - R) + par
            # F: channel cb0 + chan, the f row, column x0 - 20 + 2(h + m) + px
            want_col = x0 - MD + 2 * (hpix[:, None, None] + m) + px[:, None, None]
            assert (kind[f_at] == 1).all() and (row[f_at] == yf).all()
            assert (idx[f_at] == cb0 + chan[..., None]).all() and (col[f_at] == want_col).all()
            assert (live[f_at] == ((want_col >= 0) & (want_col < w)
                                   & (cb0 + chan[..., None] < c_n))).all()
            # G: row q, step k, pixel e (column x), by gradient
            q = np.arange(BQ)[:, None, None]                     # [q, k, e] axes
            k = np.arange(ND)[:, None]
            x = x0 + 2 * (hpix[:, None, None, None] + np.arange(4)) + px[:, None, None, None]
            if grad == 0:
                j = n - q
                want = (j * ND + k, 2 * (u0 + q) + par, x + 0 * k)
                ok = (j >= 0) & (j < ND) & (want[1] < h) & (x < w)
            else:
                j = q + 2 * R - n
                want = (j * ND + 2 * R - k, yf + 0 * q, x - MD + 2 * k)
                ok = (j >= 0) & (j < ND) & (want[2] >= 0) & (want[2] < w)
            ok = np.broadcast_to(ok, g_at.shape)
            assert (kind[g_at] == 2).all() and (live[g_at] == ok).all()
            for got, exp in zip((idx, row, col), want):
                assert (got[g_at][ok] == np.broadcast_to(exp, ok.shape)[ok]).all()
            fv, gv = vals[f_at], vals[g_at]  # [t, cc, m], [t, q, k, e]
            for e in range(4):
                acc[..., e] += np.einsum("tqk,tck->tqc", gv[..., e], fv[:, :, e_k[:, e]])
        v, at = _stores(acc / c_n, shape, cb0, x0, u0, hp, par, b)
        df[grad, at] = v
        writes[grad, at] += 1
    return df[0].reshape(shape), df[1].reshape(shape), writes


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=["x".join(map(str, s)) for s in WALK_SHAPES])
def test_correlation_backward_walk_matches_jax_vjp(shape):
    """Every gradient element is stored exactly once, each thread reads
    exactly the taps its pixels need (or a zero fill), and
    the walk's sums (in f64) equal jax.vjp of correlation_ref within 1e-5:
    JAX sums up to 441 products of O(1) in f32 (~2e-6 off at C = 9), where
    a wrong tap or store is off by O(0.1)."""
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


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_correlation_backward_plan_covers_every_output(shape):
    """correlation_bwd_plan's grid, with the kernel's block decode and
    store map, writes every element of both gradients exactly once, and
    each block walks every f row inside the image once."""
    b_n, c_n, h, w = shape
    writes = np.zeros((2, b_n * c_n * h * w), np.int32)
    for cb0, x0, u0, hp, par, grad, b in _blocks(shape):
        _, at = _stores(np.zeros((BNT, BQ, BK, 4)), shape, cb0, x0, u0, hp, par, b)
        assert len(np.unique(at)) == len(at)
        writes[grad, at] += 1
    assert (writes == 1).all()
    # the f rows inside the image, each once per block
    for hp, u0 in corr._bwd_row_groups(h):
        rows = [n for n in range(corr.BWD_DIAGONALS) if 0 <= u0 + n - R < hp]
        assert list(corr.correlation_bwd_rows(u0, hp)) == rows
