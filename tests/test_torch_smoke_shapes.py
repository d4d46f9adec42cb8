"""chip_smoke.py's shape tables of the single-image paths against the nets.

The on-card smoke times and checks respair and conv7 in f32 at the shapes
its tables list (RESPAIR_F32_SHAPES per seeding call of two frames,
CONV7_SHAPES per frame). Here the registry's nets run one frame of each
path on meta tensors (train mode, so no kernel is called; every residual
block and 7x7 conv keeps its shapes) and forward hooks collect each
ResnetBlock's input (C, H, W) and each ReflectConv7's (Ci, Co, H, W): the
tables must list exactly those, with the counts. The smoke exits without a
card at import, so it is imported here with torch.cuda.is_available
patched.
"""

import collections
import importlib
import sys

import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import make_single_image_generator, single_input_nc
from vid2vid_tpu_torch.nn.blocks import ResnetBlock
from vid2vid_tpu_torch.nn.layers import ReflectConv7
from vid2vid_tpu_torch.nn.pix2pixhd import Encoder


def _smoke(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delitem(sys.modules, "chip_smoke", raising=False)
    module = importlib.import_module("chip_smoke")
    monkeypatch.delitem(sys.modules, "chip_smoke")
    return module


def _shapes(run, *nets):
    """(respair (C, H, W) counts, conv7 (Ci, Co, H, W) list) of run()."""
    blocks, convs = collections.Counter(), []
    handles = []
    for net in nets:
        for m in net.modules():
            if isinstance(m, ResnetBlock):
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: blocks.update([tuple(args[0].shape[1:])])))
            elif isinstance(m, ReflectConv7):
                handles.append(m.register_forward_hook(
                    lambda mod, args, out: convs.append(
                        (mod.in_channels, mod.out_channels, *out.shape[2:]))))
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return blocks, convs


def test_smoke_tables_list_the_single_image_paths_shapes(monkeypatch):
    cs = _smoke(monkeypatch)
    meta = torch.device("meta")
    got = {}
    # label2city 2048x1024 seeded by the LocalEnhancer
    opt = Options(**cs.FLAGSHIP, dataroot="datasets/Cityscapes/", loadSize=2048,
                  use_single_G=True)
    net = make_single_image_generator(opt)[0].to(meta)
    x = torch.empty((1, single_input_nc(opt), *cs.CITY_HW), device=meta)
    got["label2city_single"] = _shapes(lambda: net(x), net)
    # edge2face 512x512: GlobalWithFeatures fed by the Encoder's 16 features
    opt = Options(**cs.EDGE2FACE)
    net = make_single_image_generator(opt)[0].to(meta)
    enc = Encoder(output_nc=16, ngf=16, n_downsampling=4, norm="instance").to(meta)
    x = torch.empty((1, single_input_nc(opt), *cs.FACE_HW), device=meta)
    real = torch.empty((1, 3, *cs.FACE_HW), device=meta)
    got["edge2face_single"] = _shapes(lambda: net(x, enc.model(real)), net, enc)
    for path, (blocks, convs) in got.items():
        want_blocks = {(c, h, w): n for c, h, w, n, p in cs.RESPAIR_F32_SHAPES if p == path}
        assert {k: 2 * v for k, v in blocks.items()} == want_blocks, path  # 2 frames a call
        assert sorted(convs) == sorted(shape[1:] for shape in cs.CONV7_SHAPES[path]), path
