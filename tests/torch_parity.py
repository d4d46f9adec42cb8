"""Helpers for the port-vs-JAX parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; JAX weights are
initialised by flax (or drawn with numpy into the tree that flax's init
describes), given random biases and running stats, and carried into the
port with vid2vid_tpu_torch.utils.from_jax.
"""

from __future__ import annotations

import numpy as np
import torch


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
