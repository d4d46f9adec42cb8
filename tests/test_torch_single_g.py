"""The port's single-image first-frame path against the JAX package, on CPU.

The five pix2pixHD nets (built by define_g in both packages), the
instance average, the single-image registry, the seeding of the state and
the face-feature lookup. Same numpy inputs; the JAX init with random
biases and running stats, carried into the port with from_jax. f32;
tolerance atol 2e-4 on images and features (the port's eval resblocks run
respair's plain version, its stems and heads conv7's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, nhwc, randomize
from vid2vid_tpu.config import Options as JaxOptions
from vid2vid_tpu.models.inference import InferenceEngine as JaxEngine
from vid2vid_tpu.models.inference import make_single_image_generator as jax_registry
from vid2vid_tpu.nn import pix2pixhd as jax_p2p
from vid2vid_tpu.nn.factory import define_g as jax_define_g
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine, make_single_image_generator
from vid2vid_tpu_torch.nn import pix2pixhd
from vid2vid_tpu_torch.nn.factory import define_g
from vid2vid_tpu_torch.ops.conv7 import conv7_reflect
from vid2vid_tpu_torch.ops.respair import respair
from vid2vid_tpu_torch.utils.from_jax import (
    _to_torch_layout,
    encoder_state_dict,
    jax_variables_to_state_dict,
    local_with_features_mapping,
    single_g_mapping,
    single_g_state_dict,
)

ATOL = 2e-4
SMALL = dict(label_nc=5, ngf=4, n_downsample_G=2, n_blocks=2, n_blocks_local=1,
             feat_num=3, norm="instance", isTrain=False)
H = W = 32


def _jax_vars(module, rng, *args):
    return randomize(module.init(jax.random.key(0), *map(jnp.asarray, args)), rng)


def _inputs(rng, nc, feat=0):
    x = rng.standard_normal((1, H, W, nc)).astype(np.float32)
    z = rng.standard_normal((1, H, W, feat)).astype(np.float32) if feat else None
    return x, z


@pytest.mark.parametrize("kind,n_local", [
    ("global", 1), ("local", 1), ("local", 2), ("global_with_features", 1),
    ("local_with_features", 1),
])
def test_define_g_generators_match_jax(rng, kind, n_local):
    opt = dict(SMALL, n_local_enhancers=n_local)
    jnet = jax_define_g(JaxOptions(**opt), kind)
    net = define_g(Options(**opt), kind).eval()
    feat = opt["feat_num"] if "features" in kind else 0
    x, z = _inputs(rng, 5, feat)
    args = (x,) if z is None else (x, z)
    variables = _jax_vars(jnet, rng, *args)
    want = jnet.apply(variables, *map(jnp.asarray, args))
    dims = dict(n_downsampling=2, n_blocks=2, n_local_enhancers=n_local, n_blocks_local=1)
    net.load_state_dict(single_g_state_dict(variables, kind, **dims))
    before = (conv7_reflect.launches, respair.launches)
    with torch.no_grad():
        got = net(*map(nchw, args))
    assert (conv7_reflect.launches, respair.launches) == before  # the CPU: plain
    assert got.shape == (1, 3, H, W)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


def test_local_with_features_two_levels_matches_jax(rng):
    """LocalWithFeatures at two enhancer levels (define_g takes one): the
    feature map enters the finest stem and the coarsest level's resblocks."""
    jnet = jax_p2p.LocalWithFeatures(feat_num=2, ngf=4, n_downsample_global=1,
                                     n_blocks_global=1, n_local_enhancers=2,
                                     n_blocks_local=1)
    net = pix2pixhd.LocalWithFeatures(3, feat_num=2, ngf=4, n_downsample_global=1,
                                      n_blocks_global=1, n_local_enhancers=2,
                                      n_blocks_local=1).eval()
    x, z = _inputs(rng, 3, 2)
    variables = _jax_vars(jnet, rng, x, z)
    net.load_state_dict(jax_variables_to_state_dict(
        variables, local_with_features_mapping(1, 1, 2, 1)))
    with torch.no_grad():
        got = net(nchw(x), nchw(z))
    np.testing.assert_allclose(nhwc(got), np.asarray(jnet.apply(variables, x, z)), atol=ATOL)


def test_define_g_encoder_matches_jax(rng):
    opt = dict(SMALL, feat_num=4)
    jnet, net = jax_define_g(JaxOptions(**opt), "encoder"), define_g(Options(**opt), "encoder")
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    inst = rng.integers(0, 3, (2, H // 8, W // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    variables = _jax_vars(jnet, rng, x, inst)
    want = jnet.apply(variables, jnp.asarray(x), jnp.asarray(inst))
    net.load_state_dict(encoder_state_dict(variables, n_downsampling=2))
    with torch.no_grad():
        got = net.eval()(nchw(x), torch.from_numpy(inst))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n_ids,max_instances", [(5, 64), (100, 64), (20, 7)])
def test_instance_average_matches_jax(rng, n_ids, max_instances):
    """Past the static cap (100 ids, or 20 against a cap of 7) the ids above
    the cap's largest fall into its last segment, as in the JAX package."""
    feat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    inst = rng.integers(-3, n_ids - 3, (2, 16, 16)).astype(np.int32)
    want = jax_p2p.instance_average(jnp.asarray(feat), jnp.asarray(inst), max_instances)
    got = pix2pixhd.instance_average(nchw(feat), torch.from_numpy(inst), max_instances)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    got4 = pix2pixhd.instance_average(nchw(feat), torch.from_numpy(inst)[:, None], max_instances)
    torch.testing.assert_close(got4, got, rtol=0, atol=0)


# ---------------------------------------------------------------- registry

REGISTRY = [
    (dict(dataroot="datasets/Cityscapes/", loadSize=512, label_nc=35, use_instance=True),
     "global", dict(n_downsampling=3, n_blocks=9)),
    (dict(dataroot="datasets/Cityscapes/", loadSize=1024, label_nc=35, use_instance=True),
     "global", dict(n_downsampling=4, n_blocks=9)),
    (dict(dataroot="datasets/Cityscapes/", loadSize=2048, label_nc=35, use_instance=True),
     "local", dict(n_downsampling=4, n_blocks=9, n_local_enhancers=1, n_blocks_local=3)),
    (dict(dataroot="datasets/face/", label_nc=0, input_nc=15),
     "global_with_features", dict(n_downsampling=3, n_blocks=9)),
]


@pytest.mark.parametrize("opt,kind,dims", REGISTRY, ids=["city512", "city1024", "city2048", "face"])
def test_registry_matches_jax(opt, kind, dims):
    """Every parameter and running stat of the port's registry net has the
    shape of the JAX registry net's (built on the meta device and traced
    with eval_shape: the full-width nets hold up to 170M parameters)."""
    jnet, jfeat = jax_registry(JaxOptions(**opt, isTrain=False))
    with torch.device("meta"):
        net, feat = make_single_image_generator(Options(**opt, isTrain=False))
    assert (type(net).__name__, feat) == (type(jnet).__name__, jfeat)
    n_in = 35 if "city" in opt["dataroot"].lower() else 15
    args = [jax.ShapeDtypeStruct((1, 64, 64, n_in), jnp.float32)]
    if feat:
        args.append(jax.ShapeDtypeStruct((1, 64, 64, 16), jnp.float32))
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), *args)
    want = {}
    for key, path, conv_kind in single_g_mapping(kind, **dims):
        leaf = shapes
        for part in path:
            leaf = leaf[part]
        want[key] = tuple(_to_torch_layout(np.empty(leaf.shape, np.int8), conv_kind).shape)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


@pytest.mark.parametrize("opt,match", [
    (dict(dataroot="datasets/Cityscapes/", loadSize=256), "loadSize 256"),
    (dict(dataroot="datasets/pose/"), "dataroot"),
])
def test_registry_raises_like_jax(opt, match):
    with pytest.raises(ValueError, match=match):
        jax_registry(JaxOptions(**opt, isTrain=False))
    with pytest.raises(ValueError, match=match):
        make_single_image_generator(Options(**opt, isTrain=False))


# ----------------------------------------------------------------- seeding

CITY = dict(label_nc=5, use_instance=True, n_scales_spatial=2, ngf=8, n_downsample_G=2,
            n_blocks=2, use_single_G=True, isTrain=False)


def _engines_with_single_g(rng, opt):
    """(JAX engine, its single-G params, the port's engine): the registry
    net swapped for a small GlobalGenerator, as tests/test_single_g.py does."""
    jeng = JaxEngine(JaxOptions(**opt))
    jeng.build_single_g()
    jeng._single_g = jax_p2p.GlobalGenerator(ngf=4, n_downsampling=2, n_blocks=1)
    params = _jax_vars(jeng._single_g, rng, np.zeros((1, H, W, opt["label_nc"]), np.float32))
    eng = InferenceEngine(Options(**opt), device="cpu")
    assert isinstance(eng.build_single_g(), pix2pixhd.GlobalGenerator)
    eng.single_g = pix2pixhd.GlobalGenerator(opt["label_nc"], ngf=4, n_downsampling=2,
                                             n_blocks=1).eval()
    eng.single_g.load_state_dict(single_g_state_dict(params, "global", n_downsampling=2,
                                                     n_blocks=1))
    return jeng, params, eng


def test_single_g_first_frames_seed_state(rng):
    """The instance channel is stripped, the tG-1 frames stack into the
    per-scale ring buffers; under --bf16 the net runs in f32 and only the
    state takes bf16."""
    jeng, params, eng = _engines_with_single_g(rng, CITY)
    labels = rng.integers(0, 5, (1, 2, H, W)).astype(np.int32)
    inst = rng.integers(0, 3, (1, 2, H, W)).astype(np.int32)
    want = jeng.single_g_first_frames(
        params, jeng.encode(jnp.asarray(labels), jnp.asarray(inst)))
    enc = eng.encode(torch.from_numpy(labels), torch.from_numpy(inst))
    assert enc.shape[2] == 6
    got = eng.single_g_first_frames(enc)
    assert [tuple(s.shape) for s in got] == [(1, 2, 3, H, W), (1, 2, 3, H // 2, W // 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=ATOL)

    eng16 = InferenceEngine(Options(**CITY, bf16=True), device="cpu")
    eng16.build_single_g()
    eng16.single_g = eng.single_g
    got16 = eng16.single_g_first_frames(enc)
    assert all(s.dtype == torch.bfloat16 for s in got16)
    assert next(eng16.single_g.parameters()).dtype == torch.float32
    for g16, g in zip(got16, got):
        torch.testing.assert_close(g16.float(), g, atol=1e-2, rtol=0)  # bf16 rounding


FACE = dict(dataroot="datasets/face/", label_nc=0, input_nc=3, use_instance=False,
            n_scales_spatial=1, ngf=8, n_downsample_G=2, n_blocks=2, isTrain=False)


def _face_engines(rng):
    """(JAX engine, G params, E params, port engine) with small
    GlobalWithFeatures(3 features) and Encoder(3) in place of the registry's."""
    jeng = JaxEngine(JaxOptions(**FACE))
    jeng.build_single_g({"feat_num": 3, "g": dict(ngf=4, nd=2, nb=1, norm="instance"),
                         "e": dict(out_nc=3, ngf=4, nd=2, norm="instance")})
    x = np.zeros((1, H, W, 3), np.float32)
    gparams = _jax_vars(jeng._single_g, rng, x, x)
    eparams = _jax_vars(jeng._encoder, rng, x, np.zeros((1, H, W), np.int32))
    eng = InferenceEngine(Options(**FACE), device="cpu")
    eng.build_single_g({"feat_num": 3, "g": dict(ngf=4, nd=2, nb=1, norm="instance"),
                        "e": dict(out_nc=3, ngf=4, nd=2, norm="instance")})
    eng.single_g.load_state_dict(single_g_state_dict(
        gparams, "global_with_features", n_downsampling=2, n_blocks=1))
    eng.encoder.load_state_dict(encoder_state_dict(eparams, n_downsampling=2))
    return jeng, gparams, eparams, eng


def _parts():
    """Two face parts and a background (ids 0, 1, 2) on a 32x32 map."""
    inst = np.zeros((1, H, W), np.int32)
    inst[:, 4:12, 6:20] = 1
    inst[:, 20:, 10:] = 2
    return inst


def test_face_features_joint_argmin_matches_jax(rng):
    """ONE training image for all parts (the argmin of the distance summed
    over parts), each part's row clamped to its table; a cluster of a part
    absent from the map (7) adds nothing, a part without clusters (0) stays
    zero."""
    jeng, _, eparams, eng = _face_engines(rng)
    img = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    inst = _parts()
    clusters = {1: rng.standard_normal((5, 4)).astype(np.float32),
                2: rng.standard_normal((3, 4)).astype(np.float32),
                7: rng.standard_normal((2, 4)).astype(np.float32)}
    want = np.asarray(jeng.face_features(eparams, jnp.asarray(img), jnp.asarray(inst), clusters))
    got = eng.face_features(nchw(img), torch.from_numpy(inst), clusters)
    assert got.shape == (1, 3, H, W)
    np.testing.assert_allclose(nhwc(got), want, atol=0)
    assert not np.any(want[0][inst[0] == 0])  # part 0 has no clusters
    for part in (1, 2):  # each part is one row of its table
        region = want[0][inst[0] == part]
        assert np.all(region == region[0])
    # the joint choice: the image index shared by every present part
    enc = nhwc(eng.encoder(nchw(img), torch.from_numpy(inst)))[0]
    dists = sum(((clusters[p][:3, :3] - enc[tuple(np.argwhere(inst[0] == p)[0])]) ** 2).sum(-1)
                for p in (1, 2))
    best = int(np.argmin(dists))
    np.testing.assert_array_equal(want[0][inst[0] == 1][0], clusters[1][best, :3])


def test_face_features_empty_clusters_give_zeros(rng):
    """An empty cluster dict (no features.npy) gives zeros of the Encoder's
    width. The JAX package's face_features (vid2vid_tpu/models/
    inference.py:326-327) reads the width from the dict's first entry and
    raises StopIteration there: a defect the port does not copy."""
    jeng, _, eparams, eng = _face_engines(rng)
    img = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    with pytest.raises(StopIteration):
        jeng.face_features(eparams, jnp.asarray(img), jnp.asarray(_parts()), {})
    got = eng.face_features(nchw(img), torch.from_numpy(_parts()), {})
    assert got.shape == (1, eng.encoder.output_nc, H, W) and not torch.any(got)


def test_single_image_nets_run_convs_in_f32():
    """cuDNN's TF32 is off inside the single-image G and the Encoder,
    through the seeding and through face_features alone, whatever the
    caller set, and the caller's setting is back afterwards."""
    eng = InferenceEngine(Options(**FACE), device="cpu")
    eng.build_single_g({"feat_num": 3, "g": dict(ngf=4, nd=2, nb=1, norm="instance"),
                        "e": dict(out_nc=3, ngf=4, nd=2, norm="instance")})
    seen = []
    hooks = [net.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
        for net in (eng.single_g, eng.encoder)]
    parts = torch.from_numpy(np.stack([_parts()[0]] * 2)[None])
    clusters = {1: np.ones((2, 4), np.float32)}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        eng.single_g_first_frames(torch.zeros(1, 2, 3, H, W), torch.zeros(1, 2, 3, H, W),
                                  parts, clusters)
        assert seen == [False] * 4 and torch.backends.cudnn.allow_tf32
        eng.face_features(torch.zeros(1, 3, H, W), parts[:, 0], clusters)
        assert seen == [False] * 5 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        for hook in hooks:
            hook.remove()


def test_face_single_g_first_frames_match_jax(rng):
    jeng, gparams, eparams, eng = _face_engines(rng)
    edges = rng.standard_normal((1, 2, H, W, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (1, 2, H, W, 3)).astype(np.float32)
    parts = np.stack([_parts()[0]] * 2)[None]
    clusters = {1: rng.standard_normal((4, 4)).astype(np.float32),
                2: rng.standard_normal((4, 4)).astype(np.float32)}
    want = jeng.single_g_first_frames(gparams, jnp.asarray(edges), jnp.asarray(real),
                                      jnp.asarray(parts), eparams, clusters)
    got = eng.single_g_first_frames(nchw(edges), nchw(real), torch.from_numpy(parts), clusters)
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=ATOL)
