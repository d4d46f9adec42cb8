"""Two faults of the port, held on CPU against the JAX package.

1. The kernel ops without a backward of their own (respair, correlation,
   conv3_fused_padded) wrote into fresh outputs through ctypes, so on the
   card their result had no gradient. Each is now an autograd.Function
   whose backward is its plain version's autograd: here its gradients,
   with the forward on the plain version, against `jax.vjp` of the JAX
   package's plain counterpart at f32 (the eval ResnetBlock with
   fuse=False, `correlation_ref`, `_conv3_xla` with the epilogue), and the
   result's grad_fn is the op's own, the one the card runs.
   tests/test_torch_cuda.py holds the card's gradients to the plain ones.
2. The bf16 InferenceEngine cast a copy of its generator once and never
   saw a later change to the master weights. Its copy is now keyed on the
   master parameters' and buffers' versions and storages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc, randomize
from vid2vid_tpu.nn.blocks import ResnetBlock as JaxResnetBlock
from vid2vid_tpu.ops.conv3_pallas import _conv3_xla
from vid2vid_tpu.ops.correlation import correlation_ref
from vid2vid_tpu.utils.torch_import import _resblock
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import init_weights
from vid2vid_tpu_torch.ops.conv3 import conv3_fused_padded
from vid2vid_tpu_torch.ops.correlation import correlation
from vid2vid_tpu_torch.utils.from_jax import jax_variables_to_state_dict

TOL = dict(atol=2e-4, rtol=1e-4)  # f32, another summation order


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_respair_gradient_matches_jax_block(rng, norm):
    c = 16
    x = rng.standard_normal((2, 9, 12, c)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jblock = JaxResnetBlock(c, norm, fuse=False)
    variables = randomize(jblock.init(jax.random.key(0), jnp.asarray(x)), rng)
    stats = {k: v for k, v in variables.items() if k != "params"}

    def run(params, xx):
        return jblock.apply({"params": params, **stats}, xx, train=False)

    _, vjp = jax.vjp(run, variables["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(cot))

    mapping = list(_resblock("", (), norm))
    block = ResnetBlock(c, norm).eval()
    block.load_state_dict({k[1:]: v for k, v in
                           jax_variables_to_state_dict(variables, mapping).items()})
    xt = nchw(x).requires_grad_()
    out = block(xt)
    assert type(out.grad_fn).__name__ == "_RespairBackward"
    out.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), **TOL)
    want = {k[1:]: v for k, v in jax_variables_to_state_dict(
        {"params": dparams, **stats}, mapping).items()}
    named = dict(block.named_parameters())
    assert named
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("form", ["relu", "residual"])
def test_conv3_fused_gradient_matches_jax(rng, form):
    b, h, w, ci, co = 2, 6, 10, 5, 7
    xp = rng.standard_normal((b, h + 2, w + 2, ci)).astype(np.float32)
    k = (0.3 * rng.standard_normal((3, 3, ci, co))).astype(np.float32)
    scale, offset = (rng.standard_normal(co).astype(np.float32) for _ in range(2))
    res = rng.standard_normal((b, h, w, co)).astype(np.float32)
    cot = rng.standard_normal((b, h, w, co)).astype(np.float32)
    relu = form == "relu"

    def fused(xx, kk, s, o, r):
        y = _conv3_xla(xx, kk) * s + o + (0.0 if relu else r)
        return jax.nn.relu(y) if relu else y

    _, vjp = jax.vjp(fused, *map(jnp.asarray, (xp, k, scale, offset, res)))
    want = vjp(jnp.asarray(cot))
    leaves = [nchw(xp), _oihw(k), torch.from_numpy(scale), torch.from_numpy(offset),
              nchw(res)]
    for t in leaves:
        t.requires_grad_()
    out = conv3_fused_padded(*leaves[:4], None if relu else leaves[4], relu)
    assert type(out.grad_fn).__name__ == "_Conv3FusedBackward"
    out.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(leaves[0].grad), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(leaves[1].grad.numpy(), _oihw(np.asarray(want[1])).numpy(),
                               **TOL)
    for got, w_ in zip(leaves[2:4], want[2:4]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w_), **TOL)
    if relu:
        assert leaves[4].grad is None
    else:
        np.testing.assert_allclose(nhwc(leaves[4].grad), np.asarray(want[4]), **TOL)


@pytest.mark.parametrize("md,s2", [(20, 2), (4, 1)])
def test_correlation_gradient_matches_jax(rng, md, s2):
    shape = (2, 9, 13, 5)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    d = 2 * (md // s2) + 1
    cot = rng.standard_normal(shape[:3] + (d * d,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: correlation_ref(a, b, md, s2), jnp.asarray(f1),
                     jnp.asarray(f2))
    want = vjp(jnp.asarray(cot))
    leaves = [nchw(f1).requires_grad_(), nchw(f2).requires_grad_()]
    out = correlation(*leaves, max_displacement=md, stride2=s2)
    assert type(out.grad_fn).__name__ == "_CorrelationBackward"
    out.backward(nchw(cot))
    for leaf, w_ in zip(leaves, want):
        np.testing.assert_allclose(nhwc(leaf.grad), np.asarray(w_), atol=1e-5, rtol=1e-5)


ENGINE_OPT = Options(
    label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=8,
    n_downsample_G=2, n_blocks=2, n_blocks_local=1, n_scales_spatial=2,
    n_frames_G=3, norm="batch", bf16=True, isTrain=False,
)
EH, EW = 32, 64


def _window(seed=1):
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(0, 4, (1, 3, EH, EW)))
    inst = torch.from_numpy(rng.integers(0, 3, (1, 3, EH, EW)))
    return labels, inst


def _step(eng):
    frame, _ = eng.step(*_window(), eng.initial_state(1, EH, EW))
    return frame


@pytest.mark.parametrize("change", ["init_weights", "load_state_dict"])
def test_bf16_engine_follows_the_master_weights(change):
    eng = InferenceEngine(ENGINE_OPT, device="cpu")
    init_weights(eng.gen, torch.Generator().manual_seed(0))
    before = _step(eng)
    copy = eng.compute_generator()
    assert _step(eng).equal(before) and eng.compute_generator() is copy  # no re-copy
    if change == "init_weights":
        init_weights(eng.gen, torch.Generator().manual_seed(1))
    else:
        other = InferenceEngine(ENGINE_OPT, device="cpu")
        init_weights(other.gen, torch.Generator().manual_seed(1))
        eng.gen.load_state_dict(other.gen.state_dict())
    got = _step(eng)
    assert eng.compute_generator() is not copy
    fresh = InferenceEngine(ENGINE_OPT, device="cpu")
    fresh.load_state_dict(eng.gen.state_dict())
    assert got.equal(_step(fresh)) and not got.equal(before)
