"""The published-checkpoint leg of the port, on fabricated checkpoints.

The JAX package's tools/verify_published.py holds its InferenceEngine to a
torch rollout of the reference's own architecture on published
`latest_net_G<s>.pth` files. The port needs no converter (its modules carry
the reference's state-dict names) and may not import the JAX package, so
its leg is this test: reference-architecture .pth files fabricated with
the JAX tool's `build_reference_nets` (label2city_1024_g1 at the reduced
widths the tool's own test uses) are loaded strictly into the port's
InferenceEngine through `test_cli.load_weights`, and 5 frames (2 seed
frames + 3 generated) are streamed through `InferenceEngine.step` and held
to `verify_published.torch_rollout` on the same files and inputs: the
tool's own bound on the mean abs delta (< 1e-2), and 1e-4 on the max abs
delta. Both sides run float32 on the CPU with the same weights; they
differ only in summation order (the port's composite routes its 7x7 convs
and residual blocks through conv7 / respair's plain versions, its blend
through `warp_blend_plain`'s gathers, the reference through nn.Conv2d and
grid_sample), a few f32 ulps of O(1) values.
"""

import numpy as np
import torch

from torch_parity import torch_threads
from vid2vid_tpu.tools import verify_published
from vid2vid_tpu_torch import test_cli
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine

NAME = "label2city_1024_g1"
H, W, FRAMES = 64, 128, 5


def _inputs(cfg: dict, seed: int = 0):
    """The tool's synthetic conditioning (verify_published.main): blocky
    labels, instance ids with edges at the label edges, the one-hot +
    edge maps of the reference, and seed frames."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, cfg["label_nc"], (FRAMES, H // 16, W // 16))
    labels = np.kron(blocks, np.ones((16, 16), np.int64)).astype(np.int32)
    inst = (labels * 7 + 3).astype(np.int32)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).long(), cfg["label_nc"])
    onehot = onehot.permute(0, 3, 1, 2).float()
    it = torch.from_numpy(inst)
    edge = torch.zeros_like(it, dtype=torch.bool)
    dx, dy = it[:, :, 1:] != it[:, :, :-1], it[:, 1:, :] != it[:, :-1, :]
    edge[:, :, 1:] |= dx
    edge[:, :, :-1] |= dx
    edge[:, 1:, :] |= dy
    edge[:, :-1, :] |= dy
    onehot = torch.cat([onehot, edge[:, None].float()], 1)
    real_seed = rng.uniform(-1, 1, (cfg["tG"] - 1, 3, H, W)).astype(np.float32)
    return labels, inst, onehot, real_seed


def test_port_streams_fabricated_published_checkpoints(tmp_path, monkeypatch, capsys):
    cfg = dict(verify_published.REGISTRY[NAME])
    cfg.update(ngf=8, nb=2, nbl=1, label_nc=6, fg_labels=(3,))
    monkeypatch.setitem(verify_published.REGISTRY, NAME, cfg)
    torch.manual_seed(42)
    pth_dir = tmp_path / "checkpoints" / NAME
    pth_dir.mkdir(parents=True)
    for s, net in enumerate(verify_published.build_reference_nets(NAME)):
        torch.save(net.state_dict(), pth_dir / f"latest_net_G{s}.pth")

    opt = Options(
        label_nc=cfg["label_nc"], use_instance=cfg["use_instance"], fg=cfg["fg"],
        fg_labels=cfg["fg_labels"], ngf=cfg["ngf"], n_downsample_G=cfg["nd"],
        n_blocks=cfg["nb"], n_blocks_local=cfg["nbl"], n_scales_spatial=cfg["n_scales"],
        n_frames_G=cfg["tG"], norm=cfg["norm"], isTrain=False,
        checkpoints_dir=str(tmp_path / "checkpoints"), name=NAME, which_epoch="latest",
    )
    labels, inst, onehot, real_seed = _inputs(cfg)
    tg = cfg["tG"]
    with torch_threads(1):
        eng = InferenceEngine(opt, device="cpu")
        assert test_cli.load_weights(opt, eng)  # strict: every reference name
        assert "WARNING" not in capsys.readouterr().out
        state = eng.initial_state(1, H, W, real_frames=torch.from_numpy(real_seed)[None])
        got = []
        for t in range(FRAMES - tg + 1):
            frame, state = eng.step(torch.from_numpy(labels[None, t : t + tg]),
                                    torch.from_numpy(inst[None, t : t + tg]), state)
            got.append(frame[0])
        got = torch.stack(got)
        nets = verify_published._torch_stack(NAME, str(pth_dir))
        want = verify_published.torch_rollout(NAME, nets, onehot, torch.from_numpy(real_seed),
                                              FRAMES)
    assert got.shape == want.shape == (FRAMES - tg + 1, 3, H, W)
    delta = (got - want).abs()
    assert float(delta.mean()) < 1e-2
    assert float(delta.max()) < 1e-4, float(delta.max())
    # the frames are not trivially equal: the rollout moves with the weights
    assert float(want.std()) > 1e-2
