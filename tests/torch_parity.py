"""Helpers for the port-vs-JAX parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; JAX weights are
initialised by flax (or drawn with numpy into the tree that flax's init
describes), given random biases and running stats, and carried into the
port with vid2vid_tpu_torch.utils.from_jax.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.train.loop import Trainer as JaxTrainer
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.train.loop import Trainer
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict, loss_engine_state_dict


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to `n` for the block: the small CPU nets
    of the tests run no slower on one thread, and the test workers, which
    share the machine's cores, do not oversubscribe them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def nhwc(x) -> np.ndarray:
    """A port tensor (..., C, H, W) as a numpy (..., H, W, C) array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.moveaxis(np.asarray(x), -3, -1)


def nchw(x) -> torch.Tensor:
    """A numpy / JAX (..., H, W, C) array as a port tensor (..., C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def randomize(variables: dict, rng: np.random.Generator) -> dict:
    """A copy of a flax variable tree with random biases (params named
    'bias'), running means N(0, 0.1) and running variances U(0.5, 1.5), so
    the bias and norm folding of the eval path is exercised."""

    def walk(node, collection, name=None):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, collection, k) for k, v in node.items()}
        arr = np.asarray(node, np.float32)
        if collection == "batch_stats" and name == "mean":
            return 0.1 * rng.standard_normal(arr.shape).astype(np.float32)
        if collection == "batch_stats" and name == "var":
            return (0.5 + rng.random(arr.shape)).astype(np.float32)
        if collection == "params" and name.endswith("bias"):
            return (arr + 0.05 * rng.standard_normal(arr.shape)).astype(np.float32)
        return arr

    return {col: walk(tree, col) for col, tree in variables.items()}


def init_like(shapes: dict, rng: np.random.Generator, xavier: bool = False) -> dict:
    """Variables for the tree of shapes that `jax.eval_shape(module.init,
    ...)` returns, drawn with numpy at the JAX package's initialisation:
    conv kernels N(0, 0.02) (vid2vid_tpu/nn/layers.py::conv_kernel_init),
    every other leaf zero. For networks whose flax init takes long to
    trace (FlowNet2's 162.5M parameters).

    `xavier` draws the (kh, kw, in, out) kernels xavier-uniform instead, the
    reference flow nets' own initialisation: it keeps the activations of a
    deep cascade O(1), where N(0, 0.02) leaves its output to the biases."""

    def walk(node, name=None):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        if name == "kernel" and xavier:
            kh, kw, cin, cout = node.shape
            bound = np.sqrt(6.0 / (kh * kw * (cin + cout)))
            return rng.uniform(-bound, bound, node.shape).astype(np.float32)
        if name == "kernel":
            return 0.02 * rng.standard_normal(node.shape, dtype=np.float32)
        return np.zeros(node.shape, np.float32)

    return walk(shapes)


# ------------------------------------------------ the training slice
# One small configuration for tests/test_torch_train*.py: the same weights
# in both packages (the JAX Trainer's init with random biases, carried into
# the port with from_jax), the same numpy clip, and the deterministic flow
# stub of tests/test_train_oracle.py in place of FlowNet2, once per package.
TG, TD, N_LOAD, LABEL_NC, H, W = 3, 3, 3, 4, 32, 64
LR, BETA1 = 2e-4, 0.5
CONFIG = dict(
    label_nc=LABEL_NC, use_instance=False, output_nc=3, ngf=8, n_downsample_G=2,
    n_blocks=2, n_scales_spatial=1, n_frames_G=TG, n_frames_D=TD,
    n_scales_temporal=1, ndf=8, num_D=2, n_layers_D=2, n_frames_total=6,
    max_frames_per_gpu=N_LOAD, norm="batch", fg=False, no_vgg=False, bf16=False,
    remat=False, isTrain=True, fineSize=W, lr=LR, beta1=BETA1, niter_fix_global=0,
)
# every loss scalar (tests/test_train_oracle.py::KEYS) and the grad norms
KEYS = [
    "G_VGG", "G_GAN", "G_GAN_Feat", "G_Warp", "F_Flow", "F_Warp", "W",
    "D_real", "D_fake", "G_T_GAN0", "G_T_GAN_Feat0", "D_T_real0", "D_T_fake0",
    "loss_G_total", "loss_D_total",
]
GRAD_KEYS = ["G_grad_norm", "D_grad_norm", "D_T_grad_norm0"]


def jax_stub_flow(b1, b2):
    d = b1 - b2
    fx = 2.0 * jnp.tanh(3.0 * d[..., 0])
    fy = 2.0 * jnp.tanh(3.0 * d[..., 1])
    return jnp.stack([fx, fy], -1), jax.nn.sigmoid(d[..., 2])[..., None]


def torch_stub_flow(b1, b2):
    """The same stub on (B, T, 3, H, W) frames."""
    d = b1 - b2
    flow = torch.stack([2.0 * torch.tanh(3.0 * d[:, :, 0]),
                        2.0 * torch.tanh(3.0 * d[:, :, 1])], 2)
    return flow, torch.sigmoid(d[:, :, 2:3])


def clip(seed: int = 11):
    """(labels (1, T, H, W) int32, frames (1, T, 3, H, W) f32) for two chunks."""
    rng = np.random.default_rng(seed)
    n_total = 2 * N_LOAD + TG - 1
    labels = rng.integers(0, LABEL_NC, (1, n_total, H, W)).astype(np.int32)
    real = rng.uniform(-1, 1, (1, n_total, 3, H, W)).astype(np.float32)
    return labels, real


def jax_trainer(n_frames_bp: int, **overrides):
    """The JAX Trainer with random biases; returns (trainer, state)."""
    trainer = JaxTrainer(JaxOptions(**{**CONFIG, **overrides}), flow_fn=jax_stub_flow)
    state = trainer.init_state(H, W)
    rng = np.random.default_rng(5)
    gparams = {k: randomize(v, rng) for k, v in state.gparams.items()}
    dparams = {k: randomize(v, rng) for k, v in state.dparams.items()}
    state = state.replace(
        gparams=gparams, dparams=dparams, opt_g=trainer.g_tx.init(gparams),
        opt_d=trainer.d_tx.init(dparams), opt_dt=(trainer.dt_tx.init(dparams["D_T0"]),),
    )
    trainer.schedule.n_frames_bp = n_frames_bp
    return trainer, state


def port_trainer(jax_state, n_frames_bp: int, **overrides):
    """The port's Trainer on the CPU with the JAX state's weights."""
    opt = Options(**{**CONFIG, **overrides})
    trainer = Trainer(opt, flow_fn=torch_stub_flow, device="cpu")
    state = trainer.init_state()
    trainer.gen.load_state_dict(generator_state_dict(jax_state.gparams, opt))
    trainer.engine.load_state_dict(loss_engine_state_dict(jax_state.dparams, opt))
    trainer.schedule.n_frames_bp = n_frames_bp
    return trainer, state


def run_jax(n_frames_bp: int, n_chunks: int = 2, **overrides):
    """`n_chunks` (1 or 2) chunks of the JAX Trainer: (per-chunk loss dicts,
    the state after the first chunk's steps, the initial state)."""
    labels, real = clip()
    trainer, state = jax_trainer(n_frames_bp, **overrides)
    init = _copy(state)
    carry = trainer.start_clip()
    out, after_first = [], None
    real_j = jnp.asarray(np.moveaxis(real, 2, -1))
    t_len = N_LOAD + TG - 1
    for i in (0, N_LOAD)[:n_chunks]:
        state, carry, losses = trainer.train_chunk(
            state, carry, jnp.asarray(labels[:, i : i + t_len]), real_j[:, i : i + t_len])
        out.append(losses)
        if after_first is None:
            after_first = _copy(state)
    return out, after_first, init


def _copy(tree):
    """Host copies of a JAX tree (the steps donate their state's buffers)."""
    return jax.tree.map(np.array, tree)


def run_port(jax_init, n_frames_bp: int, n_chunks: int = 2, **overrides):
    """`n_chunks` (1 or 2) chunks of the port's Trainer: (per-chunk loss
    dicts, the generator's and the engine's state_dicts after the first
    chunk)."""
    labels, real = (torch.from_numpy(a) for a in clip())
    trainer, state = port_trainer(jax_init, n_frames_bp, **overrides)
    carry = trainer.start_clip()
    out, after_first = [], None
    t_len = N_LOAD + TG - 1
    for i in (0, N_LOAD)[:n_chunks]:
        state, carry, losses = trainer.train_chunk(
            state, carry, labels[:, i : i + t_len], real[:, i : i + t_len])
        out.append(losses)
        if after_first is None:
            after_first = (
                {k: v.clone() for k, v in trainer.gen.state_dict().items()},
                {k: v.clone() for k, v in trainer.engine.state_dict().items()},
            )
    return out, after_first


def losses_within(got: list[dict], want: list[dict], extra_keys: tuple = ()) -> list[str]:
    """The keys whose values leave the bounds of tests/test_train_oracle.py:
    losses (KEYS and `extra_keys`) 2e-4 (rtol and atol) in chunk 1 and
    2e-2 in chunk 2, grad norms rtol 5e-3 / 5e-2 with atol 5e-4."""
    bad = []
    for chunk, (g, w) in enumerate(zip(got, want)):
        tol = 2e-4 if chunk == 0 else 2e-2
        gtol = 5e-3 if chunk == 0 else 5e-2
        for k in KEYS + list(extra_keys):
            if not np.isclose(g[k], w[k], rtol=tol, atol=tol):
                bad.append(f"chunk {chunk} {k}: {g[k]} vs {w[k]}")
        for k in GRAD_KEYS:
            if not np.isclose(g[k], w[k], rtol=gtol, atol=5e-4):
                bad.append(f"chunk {chunk} {k}: {g[k]} vs {w[k]}")
    return bad
