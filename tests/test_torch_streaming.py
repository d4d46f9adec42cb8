"""The port's streaming clip path (Vid2VidGenerator.generate_clip_streaming,
InferenceEngine.generate_clip_raw) against its own encode_input +
generate_clip and against the JAX package's generate_clip_raw, on CPU.

A small configuration: 4 labels plus instance edges, fg, ngf 8, 2
downsamples, 2 blocks, 2 scales, tG 3, clips of T = 4 frames at 32x64.
Against the port's own encode + generate_clip the frames are equal bit for
bit: both paths run the same operations on the same values (each frame is
encoded and pooled alone in both, and the windows hold the same frames).
Against JAX (f32, the weights of JAX's init with random biases and running
stats, carried across with from_jax): atol 2e-4 on raw frames and weights,
2e-3 on flows and blended frames, as tests/test_torch_inference.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc, randomize, torch_threads
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.layers import init_weights
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict

CONFIG = dict(
    label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=8, n_downsample_G=2,
    n_blocks=2, n_blocks_local=1, n_scales_spatial=2, n_frames_G=3, norm="batch",
    isTrain=False,
)
H, W, T = 32, 64, 4


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _clip(opt, seed=1, t=T):
    """(labels, inst or None) of t + tG - 1 frames from numpy: integer maps,
    or (B, T, input_nc, H, W) float maps when label_nc == 0."""
    rng = np.random.default_rng(seed)
    n = t + opt.n_frames_G - 1
    if opt.label_nc == 0:
        labels = rng.uniform(-1, 1, (1, n, opt.input_nc, H, W)).astype(np.float32)
    else:
        labels = rng.integers(0, opt.label_nc, (1, n, H, W)).astype(np.int32)
    inst = rng.integers(0, 3, (1, n, H, W)).astype(np.int32) if opt.use_instance else None
    return labels, inst


def _engine(opt, seed=0):
    """An engine whose weights keep the activations O(1): convs N(0,
    1 / fan_in), biases N(0, 0.1), the batch norms' running means N(0, 0.1)
    and variances U(0.5, 1.5), all from one seeded generator (the port's
    default init, N(0, 0.02), leaves these nets' frames near 0)."""
    eng = InferenceEngine(opt, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    init_weights(eng.gen, gen)
    with torch.no_grad():
        for name, t in eng.gen.state_dict().items():
            if name.endswith("weight") and t.dim() == 4:
                t.copy_(torch.randn(t.shape, generator=gen) / t[0].numel() ** 0.5)
            elif name.endswith("bias") or name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    return eng


def _t(a):
    return None if a is None else torch.from_numpy(a)


CASES = {
    "inst": dict(),
    "inst_raw_only": dict(use_raw_only=True),
    "no_inst": dict(use_instance=False),
    "float_maps": dict(label_nc=0, input_nc=3, use_instance=False, fg=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_equals_encode_then_generate_clip(case):
    kw = dict(CASES[case])
    use_raw_only = kw.pop("use_raw_only", False)
    opt = Options(**{**CONFIG, **kw})
    gen = _engine(opt).gen
    labels, inst = (_t(a) for a in _clip(opt))
    state = gen.zero_state(1, H, W)
    with torch.no_grad():
        want, want_state = gen.generate_clip(gen.encode_input(labels, inst), state,
                                             use_raw_only=use_raw_only)
    got, got_state = gen.generate_clip_streaming(labels, inst, state,
                                                 use_raw_only=use_raw_only)
    assert got.fake.shape == (1, T, 3, H, W)
    assert float(got.fake.abs().max()) > 0.1 and float(got.weight.std()) > 1e-2
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)
    for g, w in zip(got_state, want_state):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def engines():
    """(the JAX engine and its params, the port's f32 engine with them)."""
    opt = Options(**CONFIG)
    jeng = JaxEngine(JaxOptions(**CONFIG))
    rng = np.random.default_rng(0)
    params = {k: randomize(v, rng) for k, v in jeng.init(jax.random.key(0), 1, H, W).items()}
    eng = InferenceEngine(opt, device="cpu")
    eng.load_state_dict(generator_state_dict(params, opt))
    return jeng, params, eng


def test_generate_clip_raw_matches_jax(engines):
    jeng, params, eng = engines
    labels, inst = _clip(eng.opt, seed=2)
    real = np.random.default_rng(3).uniform(-1, 1, (1, 2, H, W, 3)).astype(np.float32)
    jouts, jstate = jeng.generate_clip_raw(
        params, jnp.asarray(labels), jnp.asarray(inst),
        jeng.initial_state(1, H, W, real_frames=jnp.asarray(real)))
    outs, state = eng.generate_clip_raw(
        _t(labels), _t(inst), eng.initial_state(1, H, W, real_frames=nchw(real)))
    assert outs.fake.shape == (1, T, 3, H, W) and outs.fake.dtype == torch.float32
    np.testing.assert_allclose(nhwc(outs.raw), np.asarray(jouts.raw), atol=2e-4)
    np.testing.assert_allclose(nhwc(outs.weight), np.asarray(jouts.weight), atol=2e-4)
    np.testing.assert_allclose(nhwc(outs.flow), np.asarray(jouts.flow), atol=2e-3)
    np.testing.assert_allclose(nhwc(outs.fake), np.asarray(jouts.fake), atol=2e-3)
    for got_s, want_s in zip(state, jstate):
        np.testing.assert_allclose(nhwc(got_s), np.asarray(want_s), atol=2e-3)


def test_bf16_engine_returns_f32_frames_and_a_bf16_state(engines):
    """--bf16: f32 outputs, the state in bf16, and frames within 5e-3 of the
    f32 engine's (tests/test_torch_inference.py::test_bf16_policy's bound)."""
    _, params, eng32 = engines
    eng = InferenceEngine(eng32.opt.replace(bf16=True), device="cpu")
    eng.load_state_dict(generator_state_dict(params, eng32.opt))
    labels, inst = (_t(a) for a in _clip(eng.opt, seed=4))
    outs, state = eng.generate_clip_raw(labels, inst, eng.initial_state(1, H, W))
    want, _ = eng32.generate_clip_raw(labels, inst, eng32.initial_state(1, H, W))
    assert all(o.dtype == torch.float32 for o in outs)
    assert all(s.dtype == torch.bfloat16 for s in state)
    torch.testing.assert_close(outs.fake, want.fake, atol=5e-3, rtol=0)


def test_two_half_clips_chained_equal_the_whole_clip(engines):
    _, _, eng = engines
    labels, inst = (_t(a) for a in _clip(eng.opt, seed=5))
    zero = eng.initial_state(1, H, W)
    whole, whole_state = eng.generate_clip_raw(labels, inst, zero)
    tg, half = eng.opt.n_frames_G, T // 2
    first, state = eng.generate_clip_raw(labels[:, : half + tg - 1], inst[:, : half + tg - 1],
                                         zero)
    second, state = eng.generate_clip_raw(labels[:, half:], inst[:, half:], state)
    for w, a, b in zip(whole, first, second):
        assert torch.equal(w, torch.cat([a, b], 1))
    for w, s in zip(whole_state, state):
        assert torch.equal(w, s)
