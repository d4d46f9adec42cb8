"""The port's serving artifact (tools/export.py) and its operators
(ops/library.py), on the CPU.

The config is tests/test_export.py's (label_nc 8, instance maps, ngf 8, 2
downsamples, 2 blocks, 1 scale, f32, 32x64). Its weights are drawn with
numpy into the tree of the JAX engine's init (`jax.eval_shape`, which
skips a ~10 s flax init), at the JAX package's initialisation with random
biases, norm scales and running stats, and carried to the port by
utils/from_jax.py. On the CPU the artifact's operators run their plain
versions, as `InferenceEngine.step` does, so the two agree bit for bit;
against the JAX package's own artifact the frames agree within the 2e-3
of tests/test_torch_inference.py (the blend's warp, f32 rounding in
another order).
"""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vid2vid_tpu_torch.nn.blocks as port_blocks
import vid2vid_tpu_torch.nn.layers as port_layers
from torch_parity import init_like, nhwc, randomize, torch_threads
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu.tools import export as jax_export
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.ops.library import served_ops
from vid2vid_tpu_torch.tools import export
from vid2vid_tpu_torch.utils.from_jax import generator_state_dict

CFG = dict(label_nc=8, use_instance=True, fg=False, ngf=8, n_downsample_G=2, n_blocks=2,
           n_scales_spatial=1, n_frames_G=3, norm="batch", bf16=False, isTrain=False)
H, W = 32, 64


def _windows(seed=0, frames=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 8, (1, CFG["n_frames_G"] + frames - 1, H, W)).astype(np.int32)
    inst = rng.integers(0, 3, labels.shape).astype(np.int32)
    return labels, inst


def _jax_params(rng: np.random.Generator) -> dict:
    """The JAX engine's variables, drawn with numpy (init_like, randomize),
    the norm scales N(1, 0.02)."""
    jeng = JaxEngine(JaxOptions(**CFG))
    shapes = jax.eval_shape(lambda: jeng.init(jax.random.key(0), 1, H, W))

    def scales(node, name=None):
        if isinstance(node, dict):
            return {k: scales(v, k) for k, v in node.items()}
        if name == "scale":
            return (1.0 + 0.02 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    return {k: randomize(scales(init_like(v, rng)), rng) for k, v in shapes.items()}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(JAX params, port engine with the same weights, artifact directory)."""
    params = _jax_params(np.random.default_rng(0))
    opt = Options(**CFG)
    with torch_threads(1):
        eng = InferenceEngine(opt, device="cpu")
        eng.load_state_dict(generator_state_dict(params, opt))
        out = tmp_path_factory.mktemp("port") / "artifact"
        export.save_exported(str(out), opt, eng, 1, H, W)
    return params, eng, out


def test_artifact_round_trip_equals_engine_step(artifact):
    _, eng, out = artifact
    labels, inst = _windows()
    tg = CFG["n_frames_G"]
    with torch_threads(1):
        step = export.load_exported(str(out), "cpu")
        state_ref, state = eng.initial_state(1, H, W), None
        for t in range(2):
            lw = torch.from_numpy(labels[:, t : t + tg])
            iw = torch.from_numpy(inst[:, t : t + tg])
            want, state_ref = eng.step(lw, iw, state_ref)
            got, state = step(lw, iw, state)
            assert got.dtype == torch.float32 and got.shape == (1, 3, H, W)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            for s_got, s_want in zip(state, state_ref):
                torch.testing.assert_close(s_got, s_want, rtol=0, atol=0)


def test_artifact_files(artifact):
    _, _, out = artifact
    for name in export.FILES:
        assert (out / name).exists(), name
    meta = json.loads((out / "meta.json").read_text())
    assert meta["device"] == "cpu" and (meta["height"], meta["width"]) == (H, W)
    assert meta["n_state"] == CFG["n_scales_spatial"] and meta["n_params"] > 0


def test_artifact_matches_jax_exported_step(artifact, tmp_path):
    params, _, out = artifact
    jax_dir = str(tmp_path / "jax")
    jax_export.save_exported(jax_dir, JaxOptions(**CFG), params, 1, H, W)
    jax_step = jax_export.load_exported(jax_dir)
    labels, inst = _windows(seed=1)
    tg = CFG["n_frames_G"]
    with torch_threads(1):
        step = export.load_exported(str(out), "cpu")
        jstate = state = None
        for t in range(2):
            want, jstate = jax_step(jnp.asarray(labels[:, t : t + tg]),
                                    jnp.asarray(inst[:, t : t + tg]), jstate)
            got, state = step(labels[:, t : t + tg], inst[:, t : t + tg], state)
            np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-3,
                                       err_msg=f"frame {t}")
    for s_got, s_want in zip(state, jstate):  # the ring buffers
        np.testing.assert_allclose(nhwc(s_got), np.asarray(s_want), atol=2e-3)


def test_load_refuses_another_device(artifact):
    with pytest.raises(ValueError, match="exported for cpu"):
        export.load_exported(str(artifact[2]), "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_exported(str(artifact[2]), "cuda")


def test_step_refuses_other_windows(artifact):
    step = export.load_exported(str(artifact[2]), "cpu")
    labels, inst = _windows()
    with pytest.raises(ValueError, match="the artifact takes"):
        step(labels[:, :2], inst[:, :2])
    with pytest.raises(ValueError, match="the artifact takes"):
        step(labels[:, :3, :16], inst[:, :3, :16])


def _node_counts(program) -> collections.Counter:
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def test_graph_reads_the_eval_caches(artifact, monkeypatch):
    """The exported graph takes the eval layers' kernel arguments as
    constants: against an export whose layers rebuild them on every step,
    the same operators and no folding of the norms (rsqrt). The weights
    stay the graph's parameters: no constant is a second copy of one."""
    _, eng, _ = artifact
    opt = Options(**CFG)
    with torch_threads(1):
        program = export.build_exported(opt, eng, 1, H, W)[0]
        cached = _node_counts(program)
        rebuild = lambda module, x, tensors, build: build(x)  # noqa: E731
        monkeypatch.setattr(port_layers, "eval_cached", rebuild)
        monkeypatch.setattr(port_blocks, "eval_cached", rebuild)
        rebuilt = _node_counts(export.build_exported(opt, eng, 1, H, W)[0])
    ops = {f"v2v.{name}.default" for name in served_ops()}
    # 2 respair a scale (2 blocks); stems and heads: label, prev, img, flow, weight
    want_ops = {"v2v.respair.default": 2 * 2, "v2v.conv7.default": 5,
                "v2v.warp_blend.default": 1}
    assert {k: v for k, v in cached.items() if k in ops} == want_ops
    assert {k: v for k, v in rebuilt.items() if k in ops} == want_ops
    assert "aten.rsqrt.default" not in cached and "aten.rsqrt.default" in rebuilt
    other = sum(v for k, v in cached.items() if k not in ops)
    assert other < sum(v for k, v in rebuilt.items() if k not in ops)
    params = {t.untyped_storage().data_ptr() for t in program.state_dict.values()}
    assert program.constants and not any(
        t.untyped_storage().data_ptr() in params for t in program.constants.values())


def test_the_graph_holds_no_batch_norm(artifact):
    """The stems', down and up convs' norms are folded into their weights
    (nn/layers.py::tie_norm): the exported step, whose frames are the
    eager step's (test_artifact_round_trip_equals_engine_step), holds no
    batch-norm node; the eager step that fills the caches and the trace
    fold all 10 each (2 trunks x 3, 2 up blocks a branch)."""
    _, eng, _ = artifact
    with torch_threads(1):
        folded = port_layers.folded_calls
        program = export.build_exported(Options(**CFG), eng, 1, H, W)[0]
    assert port_layers.folded_calls - folded == 2 * 10
    assert not [k for k in _node_counts(program) if "batch_norm" in k]


def test_main_without_checkpoint_warns_and_exports(tmp_path, capsys):
    out = tmp_path / "exported"
    with torch_threads(1):
        export.main([
            "--out", str(out), "--height", str(H), "--width", str(W), "--gpu_ids", "-1",
            "--checkpoints_dir", str(tmp_path / "checkpoints"), "--name", "tiny",
            "--label_nc", "8", "--ngf", "8", "--n_downsample_G", "2", "--n_blocks", "2",
            "--n_scales_spatial", "1",
        ])
    text = capsys.readouterr().out
    assert "WARNING: no checkpoint" in text and "exported serving artifact" in text
    for name in export.FILES:
        assert (out / name).exists(), name


def _opcheck_cases(gen: torch.Generator) -> dict:
    def r(*shape):
        return torch.randn(*shape, generator=gen)

    x, k0, k1 = r(1, 8, 6, 7), r(8, 8, 3, 3), r(8, 8, 3, 3)
    a, c = torch.rand(8, generator=gen) + 0.5, r(8)
    w, bias = r(4, 8, 7, 7), r(4)
    prev, flow = r(2, 3, 5, 6), 2 * r(2, 2, 5, 6)
    return {
        "respair": [(x, k0, a, c, k1, a, c, None, None)],
        "conv7": [(x, w, bias, None, True), (r(1, 8, 10, 12), w, None, None, False)],
        "warp_blend": [(r(2, 3, 5, 6), prev, flow, torch.rand(2, 1, 5, 6, generator=gen))],
    }


@pytest.mark.parametrize("name", ["respair", "conv7", "warp_blend"])
def test_opcheck(name):
    op = served_ops()[name]
    for args in _opcheck_cases(torch.Generator().manual_seed(0))[name]:
        torch.library.opcheck(op, args)
