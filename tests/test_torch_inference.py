"""The port's main-path slice as a whole against the JAX package, on CPU.

Streaming inference with a small composite generator stack: 2 spatial
scales, fg branch, instance edges, tG 3, at 64x256, with
--pallas_resblocks so the JAX side runs its whole-respair Pallas kernel
(interpret mode on CPU) on the 128-channel trunk. Same weights (JAX init,
random biases and running stats, carried across with from_jax), same
labels. Tolerances: atol 2e-4 on raw frames and weights, 2e-3 on flow and
blended frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vid2vid_tpu.nn.blocks as jax_blocks
from torch_parity import nchw, nhwc, randomize
from vid2vid_tpu.config import Options
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.ops.respair import respair
from vid2vid_tpu_torch.ops.warp import warp_blend
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict

OPT = Options(
    label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=32,
    n_downsample_G=2, n_blocks=3, n_blocks_local=1, n_scales_spatial=2,
    n_frames_G=3, norm="batch", pallas_resblocks=True, isTrain=False,
)
H, W, T = 64, 256, 3


@pytest.fixture(scope="module")
def engines():
    """(jax engine, jax params, port engine, respair_pallas call count)."""
    calls = []
    orig = jax_blocks.respair_pallas

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_blocks, "respair_pallas", counting)
    rng = np.random.default_rng(0)
    jeng = JaxEngine(OPT)
    params = {k: randomize(v, rng) for k, v in jeng.init(jax.random.key(0), 1, H, W).items()}
    eng = InferenceEngine(OPT, device="cpu")
    eng.load_state_dict(generator_state_dict(params, OPT))
    yield jeng, params, eng, calls
    mp.undo()


def _stream(seed=1):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, OPT.label_nc, (1, T + 2, H, W)).astype(np.int32)
    inst = rng.integers(0, 4, (1, T + 2, H, W)).astype(np.int32)
    return labels, inst


def test_step_stream_from_zero_state(engines):
    jeng, params, eng, calls = engines
    labels, inst = _stream()
    jstate = jeng.initial_state(1, H, W)
    state = eng.initial_state(1, H, W)
    for t in range(T):
        jwin = (jnp.asarray(labels[:, t : t + 3]), jnp.asarray(inst[:, t : t + 3]))
        want, jstate = jeng.step(params, *jwin, jstate)
        got, state = eng.step(torch.from_numpy(labels[:, t : t + 3]),
                              torch.from_numpy(inst[:, t : t + 3]), state)
        assert got.shape == (1, 3, H, W) and got.dtype == torch.float32
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-3,
                                   err_msg=f"frame {t}")
    for got_s, want_s in zip(state, jstate):  # the ring buffers, finest first
        np.testing.assert_allclose(nhwc(got_s), np.asarray(want_s), atol=2e-3)
    # the JAX side ran its Pallas respair kernel; the port on CPU ran none
    assert calls and all(s[-1] == 128 for s in calls)
    assert respair.launches == 0 and warp_blend.launches == 0


def test_clip_from_real_frames(engines):
    jeng, params, eng, _ = engines
    labels, inst = _stream(seed=2)
    real = np.random.default_rng(3).uniform(-1, 1, (1, 2, H, W, 3)).astype(np.float32)
    jstate = jeng.initial_state(1, H, W, real_frames=jnp.asarray(real))
    state = eng.initial_state(1, H, W, real_frames=nchw(real))
    jouts, jnew = jeng.generate_clip(
        params, jeng.encode(jnp.asarray(labels), jnp.asarray(inst)), jstate
    )
    outs, new = eng.generate_clip(
        eng.encode(torch.from_numpy(labels), torch.from_numpy(inst)), state
    )
    assert outs.fake.shape == (1, T, 3, H, W)
    np.testing.assert_allclose(nhwc(outs.raw), np.asarray(jouts.raw), atol=2e-4)
    np.testing.assert_allclose(nhwc(outs.weight), np.asarray(jouts.weight), atol=2e-4)
    np.testing.assert_allclose(nhwc(outs.flow), np.asarray(jouts.flow), atol=2e-3)
    np.testing.assert_allclose(nhwc(outs.fake), np.asarray(jouts.fake), atol=2e-3)
    for got_s, want_s in zip(new, jnew):
        np.testing.assert_allclose(nhwc(got_s), np.asarray(want_s), atol=2e-3)


def test_bf16_policy(engines):
    """--bf16: float32 master weights, a bfloat16 compute copy, inputs and
    state cast at entry, float32 frames out. Against the f32 engine the
    frames agree to 5e-3 (measured ~6e-4 here: bf16 keeps 8 bits, frames
    are ~5e-2 in size at these random weights)."""
    _, params, eng32, _ = engines
    eng = InferenceEngine(OPT.replace(bf16=True), device="cpu")
    eng.load_state_dict(generator_state_dict(params, OPT))
    labels, inst = (torch.from_numpy(a) for a in _stream(seed=4))
    state, state32 = eng.initial_state(1, H, W), eng32.initial_state(1, H, W)
    for t in range(2):
        frame, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
        want, state32 = eng32.step(labels[:, t : t + 3], inst[:, t : t + 3], state32)
        assert frame.dtype == torch.float32
        assert all(s.dtype == torch.bfloat16 for s in state)
        torch.testing.assert_close(frame, want, atol=5e-3, rtol=0)
    assert next(eng.gen.parameters()).dtype == torch.float32
    assert next(eng.compute_generator().parameters()).dtype == torch.bfloat16


def test_unported_first_frame_strategies_raise():
    """--n_devices > 1 is still unported; the single-image generator (the
    label2city 512 registry: GlobalGenerator, ngf 64, 3 downsamples) now
    builds, in f32 and eval mode on the engine's device."""
    eng = InferenceEngine(OPT, device="cpu")
    g = eng.build_single_g()
    assert type(g).__name__ == "GlobalGenerator" and not eng.single_needs_feat
    assert not g.training and next(g.parameters()).dtype == torch.float32
    assert g.model[1].weight.shape == (64, OPT.label_nc, 7, 7)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(OPT.replace(n_devices=2))
