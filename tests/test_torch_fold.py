"""The eval-mode fold of the block builders' norms into the conv before
them (nn/layers.py::tie_norm, FoldsNorm; nn/blocks.py::conv_stem,
down_block, up_block), on the CPU.

Each builder's layers against the same layers unfolded (the conv, then
F.batch_norm / F.instance_norm on the running stats, then the ReLU), in
f32 and bf16; train mode and norm_layer('none') exactly as untied layers;
the state-dict names; the folded weights' cache; the tie through
`deepcopy(...).to(bf16)`; and a tiny 3-scale fg label2city step, whose 39
stem, down and up norms all fold and none runs a batch-norm pass.
"""

import collections
import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import vid2vid_tpu_torch.nn.blocks as blocks
import vid2vid_tpu_torch.nn.layers as layers
from torch_parity import torch_threads
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.composite import CompositeGenerator, CompositeLocalGenerator
from vid2vid_tpu_torch.nn.layers import (
    DownConv2d,
    FoldedReflectionPad2d,
    FoldsNorm,
    ReflectConv7,
    UpConvTranspose2d,
)
from vid2vid_tpu_torch.nn.pix2pixhd import GlobalGenerator

BUILDERS = {"conv_stem": blocks.conv_stem, "down_block": blocks.down_block,
            "up_block": blocks.up_block}
NORMS = ("batch", "instance", "none")
BF16_EPS = 2.0**-7
# relative L2 gap to the f32 computation of the same bf16 parameters and
# input: the fold rounds each folded weight once, where the unfolded layers
# round the conv's output and the norm's (here the fold reads 2.0-2.5e-3,
# the unfolded bf16 layers 1.6-2.4e-3)
BF16_REL = BF16_EPS / 2
F32_REL = 1e-5
# tests/test_torch_spans.py's tiny 3-scale label2city with fg, with the
# flagship's 3 downsamples: G0 2 trunks x 4 + 3 + 3 + fg 4 + 3 = 21 norms,
# G1 and G2 2 + 2 + 1 + 1 + 2 + 1 = 9 each
STACK = dict(label_nc=8, use_instance=True, fg=True, fg_labels=(3,), ngf=8, n_downsample_G=3,
             n_blocks=2, n_blocks_local=1, n_scales_spatial=3, n_frames_G=3, norm="batch",
             bf16=False, isTrain=False)
H, W = 64, 128


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _randomized(seq: nn.Module, seed: int = 0, convs: bool = True) -> nn.Module:
    """seq with random norm scales, shifts and running stats (init_weights
    leaves the stats at 0 and 1, which fold to nearly nothing) and, with
    `convs`, random conv weights and biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in seq.modules():
            if convs and isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.2)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g))
            elif isinstance(m, (nn.BatchNorm2d, nn.InstanceNorm2d)):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 2 + 0.25)
                if m.affine:
                    m.weight.copy_(1 + 0.3 * torch.randn(m.weight.shape, generator=g))
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    return seq


def _built(name: str, norm: str, cin: int = 5, cout: int = 6) -> nn.Sequential:
    return _randomized(nn.Sequential(*BUILDERS[name](cin, cout, norm)))


@torch.no_grad()
def _unfolded(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """The layers as the reference runs them, in f32: the conv, then the
    norm on its running stats, then the ReLU."""
    x = x.float()
    for m in seq:
        if isinstance(m, FoldedReflectionPad2d):
            x = F.pad(x, (3, 3, 3, 3), mode="reflect")
        elif isinstance(m, ReflectConv7):
            x = F.conv2d(x, m.weight.float(), m.bias.float())
        elif isinstance(m, DownConv2d):
            x = F.conv2d(x, m.weight.float(), m.bias.float(), 2, 1)
        elif isinstance(m, UpConvTranspose2d):
            x = F.conv_transpose2d(x, m.weight.float(), m.bias.float(), 2, 1, output_padding=1)
        elif isinstance(m, nn.BatchNorm2d):
            x = F.batch_norm(x, m.running_mean.float(), m.running_var.float(), m.weight.float(),
                             m.bias.float(), False, 0.0, m.eps)
        elif isinstance(m, nn.InstanceNorm2d):
            x = F.instance_norm(x, m.running_mean.float(), m.running_var.float(),
                                use_input_stats=False, eps=m.eps)
        else:  # ReLU, Identity
            x = m(x)
    return x


def _untied(module: nn.Module) -> nn.Module:
    """A deep copy of module with every tie cut: the layers as they ran
    before the fold."""
    other = copy.deepcopy(module)
    for m in other.modules():
        if isinstance(m, FoldsNorm):
            m._norm = ()
        if isinstance(m, (layers.BatchNorm2d, layers.InstanceNorm2d)):
            m._conv = ()
    return other


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", BUILDERS)
def test_the_eval_fold_equals_the_unfolded_layers(name, norm, dtype):
    seq = _built(name, norm).eval().to(dtype)
    x = torch.randn(2, 5, 12, 20, generator=torch.Generator().manual_seed(1)).to(dtype)
    conv = next(m for m in seq if isinstance(m, FoldsNorm))
    assert (conv.folded_norm() is not None) == (norm != "none")
    before = layers.folded_calls
    with torch.no_grad():
        got = seq(x)
    assert layers.folded_calls - before == (norm != "none")
    want = _unfolded(seq, x)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= (F32_REL if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("name", BUILDERS)
def test_the_fold_with_gradients_reaches_the_conv_and_the_norm(name):
    seq = _built(name, "batch").eval()
    x = torch.randn(1, 5, 12, 20, generator=torch.Generator().manual_seed(2))
    y = seq(x)
    torch.testing.assert_close(y, _unfolded(seq, x), rtol=F32_REL, atol=1e-5)
    y.square().sum().backward()
    conv, norm = (m for m in seq if isinstance(m, (FoldsNorm, nn.BatchNorm2d)))
    assert conv._eval_cache is None  # made anew each call from the live tensors
    for p in (conv.weight, conv.bias, norm.weight, norm.bias):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", BUILDERS)
def test_train_mode_is_the_untied_layers(name, norm):
    seq = _built(name, norm).train()
    ref = _untied(seq)
    x = torch.randn(2, 5, 12, 20, generator=torch.Generator().manual_seed(3))
    before = layers.folded_calls
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    got, want = seq(xs[0]), ref(xs[1])
    assert layers.folded_calls == before
    assert torch.equal(got, want)
    got.sum().backward()
    want.sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    for (k, a), b in zip(seq.state_dict().items(), ref.state_dict().values(), strict=True):
        assert torch.equal(a, b), k
    for (k, a), b in zip(seq.named_parameters(), ref.parameters(), strict=True):
        assert torch.equal(a.grad, b.grad), k
    stats = [m for m in seq.modules() if isinstance(m, (nn.BatchNorm2d, nn.InstanceNorm2d))]
    for m in stats:  # the running stats still update
        fresh = m.running_var.clone()
        seq(x)
        assert not torch.equal(m.running_var, fresh)


NETS = {
    "G0": lambda: CompositeGenerator(24, 6, ngf=8, n_downsampling=3, n_blocks=2, use_fg=True),
    "G1": lambda: CompositeLocalGenerator(24, 6, ngf=8, n_blocks_local=1, n_downsample_g=3,
                                          scale=1, use_fg=True),
    "pix2pixHD": lambda: GlobalGenerator(5, ngf=8, n_downsampling=2, n_blocks=1,
                                         norm="instance"),
}


@pytest.mark.parametrize("net", NETS)
def test_state_dict_names_are_the_untied_nets(net, monkeypatch):
    tied = NETS[net]()
    with monkeypatch.context() as m:
        m.setattr(blocks, "tie_norm", lambda conv, norm: None)
        plain = NETS[net]()
    assert list(tied.state_dict()) == list(plain.state_dict())
    assert [n for n, _ in tied.named_modules()] == [n for n, _ in plain.named_modules()]
    convs = [m for m in tied.modules() if isinstance(m, FoldsNorm) and m._norm]
    norms = [m for m in tied.modules() if isinstance(m, (nn.BatchNorm2d, nn.InstanceNorm2d))]
    in_blocks = {id(m) for b in tied.modules() if isinstance(b, blocks.ResnetBlock)
                 for m in b.modules()}
    assert len(convs) == sum(id(m) not in in_blocks for m in norms) > 0


def _change(seq: nn.Sequential, which: str) -> None:
    norm = next(m for m in seq if isinstance(m, nn.BatchNorm2d))
    with torch.no_grad():
        if which == "load_state_dict":
            seq.load_state_dict(_randomized(copy.deepcopy(seq), seed=7).state_dict())
        elif which == "norm.weight":
            norm.weight.mul_(1.5)
        else:
            getattr(norm, which).add_(0.5)


@pytest.mark.parametrize("which", ["running_mean", "running_var", "norm.weight",
                                   "load_state_dict"])
@pytest.mark.parametrize("name", BUILDERS)
def test_the_cache_is_rebuilt_when_the_conv_or_norm_changes(name, which):
    seq = _built(name, "batch").eval()
    conv = next(m for m in seq if isinstance(m, FoldsNorm))
    x = torch.randn(1, 5, 12, 20, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        seq(x)
        cache = conv._eval_cache
        seq(x)
        assert conv._eval_cache is cache
        _change(seq, which)
        got = seq(x)
    assert conv._eval_cache is not cache
    assert _rel(got, _unfolded(seq, x)) <= F32_REL


def _ties(gen: nn.Module) -> list:
    return [(m, m._norm[0]) for m in gen.modules() if isinstance(m, FoldsNorm) and m._norm]


def test_the_bf16_compute_copy_ties_each_conv_to_its_own_norm():
    eng = InferenceEngine(Options(**dict(STACK, bf16=True)), device="cpu")
    copied = eng.compute_generator()
    assert copied is not eng.gen
    own = {id(m) for m in copied.modules()}
    master = {id(m) for m in eng.gen.modules()}
    ties, master_ties = _ties(copied), _ties(eng.gen)
    assert len(ties) == len(master_ties) == 39
    for (conv, norm), (mconv, mnorm) in zip(ties, master_ties, strict=True):
        assert id(conv) in own and id(norm) in own
        assert id(conv) not in master and id(norm) not in master
        assert norm._conv[0] is conv and mnorm._conv[0] is mconv
        assert conv.weight.dtype == norm.running_var.dtype == torch.bfloat16


def _window(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, 8, (1, STACK["n_frames_G"], H, W), generator=g, dtype=torch.int32)
    return labels, torch.randint(0, 3, labels.shape, generator=g, dtype=torch.int32)


def test_a_composite_step_folds_39_norms_and_runs_no_batch_norm(monkeypatch):
    torch.manual_seed(0)
    eng = InferenceEngine(Options(**STACK), device="cpu")
    _randomized(eng.gen, convs=False)
    calls = collections.Counter()
    batch_norm = F.batch_norm

    def counted(*args, **kwargs):
        calls["batch_norm"] += 1
        return batch_norm(*args, **kwargs)

    monkeypatch.setattr(F, "batch_norm", counted)
    labels, inst = _window()
    before = layers.folded_calls
    frame, _ = eng.step(labels, inst, eng.initial_state(1, H, W))
    assert layers.folded_calls - before == 39
    assert calls["batch_norm"] == 0
    eng.gen = _untied(eng.gen)  # the same weights, every norm a pass of its own
    want, _ = eng.step(labels, inst, eng.initial_state(1, H, W))
    assert calls["batch_norm"] == 39
    torch.testing.assert_close(frame, want, rtol=0, atol=1e-4)
