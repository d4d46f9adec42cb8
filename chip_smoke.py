"""On-card smoke test of the PyTorch / CUDA port (vid2vid_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (one stdout line each, or a few; any failure raises and exits
non-zero):
  1. device: name, power limit, torch / CUDA versions;
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds, ptxas report);
  3. kernels vs their plain PyTorch versions at the paths' shapes, with
     the tolerances below: respair and warp_blend (label2city) in f32 and
     bf16, correlation (FlowNetC, f32) and flow_warp (FlowNet2, f32 and
     bf16);
  4. small-input references: the port on the card (kernels) against the
     port on the CPU (plain versions), same weights, f32: the label2city
     generator and the FlowNet2 FlowEstimator;
  5. the label2city path: the flagship configuration at 2048x1024
     (3 scales, ngf 128, fg, instance edges, bf16) streaming frames through
     InferenceEngine.step, with every kernel's launch count checked;
  5b. the FlowNet2 reference-flow path: FlowEstimator at full FlowNet2
     width (162.5M parameters, f32) on (B=1, T=2) pairs of 1024x2048
     frames, with every kernel's launch count checked;
  6. kernel and plain times at the paths' shapes.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from vid2vid_tpu.config import Options  # noqa: E402
from vid2vid_tpu_torch.kernels import build  # noqa: E402
from vid2vid_tpu_torch.models.flownet2.nets import init_flownet_weights  # noqa: E402
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator  # noqa: E402
from vid2vid_tpu_torch.models.inference import InferenceEngine  # noqa: E402
from vid2vid_tpu_torch.nn.layers import init_weights  # noqa: E402
from vid2vid_tpu_torch.ops.correlation import correlation, correlation_plain  # noqa: E402
from vid2vid_tpu_torch.ops.respair import respair, respair_plain  # noqa: E402
from vid2vid_tpu_torch.ops.warp import (  # noqa: E402
    flow_warp,
    flow_warp_plain,
    warp_blend,
    warp_blend_plain,
)

DEV = torch.device("cuda", 0)

# (C, H, W, calls per frame) of every respair on the main path at 2048x1024
RESPAIR_SHAPES = [
    (1024, 32, 64, 18), (512, 32, 64, 9),
    (128, 256, 512, 6), (64, 256, 512, 3),
    (64, 512, 1024, 6), (32, 512, 1024, 3),
]
# (H, W) of the three warp + blend calls per frame
WARP_SHAPES = [(256, 512), (512, 1024), (1024, 2048)]
# (B, C, H, W) of FlowNetC's correlation: FlowEstimator on two 1024x2048
# pairs (the first, the shape of the FlowNet2 phase), then the 1024x512 and
# 512x256 training recipes' pairs
CORR_SHAPES = [(2, 256, 128, 256), (2, 256, 64, 128), (2, 256, 32, 64)]
# (B, C, H, W) of FlowNet2's five unfused warps per FlowEstimator call
FLOW_WARP_SHAPE = (2, 3, 1024, 2048)

# Tolerances, kernel vs plain on the same inputs. The plain reference runs
# in f32 with TF32 off. bf16: the kernel's inputs are bf16 and the plain
# version runs in f32 on the same (upcast) values. The warp bf16 bound adds
# rtol 4e-3 to atol 1e-2: the kernel's only rounding is the final store to
# bf16, up to 2**-8 of the value, which exceeds 1e-2 where |out| > 2.56.
TOL = {
    ("respair", torch.float32): dict(atol=1e-3, rtol=1e-4),
    ("respair", torch.bfloat16): dict(atol=5e-2, rtol=2e-2),
    ("warp_blend", torch.float32): dict(atol=1e-5, rtol=0.0),
    ("warp_blend", torch.bfloat16): dict(atol=1e-2, rtol=4e-3),
    ("flow_warp", torch.float32): dict(atol=1e-5, rtol=0.0),
    ("flow_warp", torch.bfloat16): dict(atol=1e-2, rtol=4e-3),
    # the correlation is a multiply-sum on the CUDA cores in both versions
    # (TF32 never touches it); only the summation order differs
    ("correlation", torch.float32): dict(atol=1e-5, rtol=1e-5),
}
KERNELS = {"respair": respair, "warp_blend": warp_blend,
           "flow_warp": flow_warp, "correlation": correlation}
FLAGSHIP = dict(
    label_nc=35, use_instance=True, fg=True, fg_labels=(26,), ngf=128,
    n_downsample_G=3, n_blocks=9, n_blocks_local=3, n_scales_spatial=3,
    n_frames_G=3, norm="batch", bf16=True, pallas_resblocks=True, isTrain=False,
)
SMALL = dict(
    label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=32,
    n_downsample_G=2, n_blocks=3, n_blocks_local=1, n_scales_spatial=2,
    n_frames_G=3, norm="batch", isTrain=False,
)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def respair_case(c, h, w, dtype, gen):
    x = torch.randn((1, c, h, w), generator=gen)
    k0, k1 = (torch.randn((c, c, 3, 3), generator=gen) / math.sqrt(9 * c)
              for _ in range(2))
    ab = [(1.0 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
          for _ in range(2)]
    x, k0, k1 = (t.to(DEV, dtype) for t in (x, k0, k1))
    ab0, ab1 = (tuple(v.to(DEV) for v in pair) for pair in ab)
    return x, k0, ab0, k1, ab1


def warp_case(h, w, dtype, gen):
    raw = torch.randn((1, 3, h, w), generator=gen)
    prev = torch.randn((1, 3, h, w), generator=gen)
    # flows of several pixels, so the samples also run past the borders
    flow = 8.0 * torch.randn((1, 2, h, w), generator=gen)
    weight = torch.sigmoid(torch.randn((1, 1, h, w), generator=gen))
    return tuple(t.to(DEV, dtype) for t in (raw, prev, flow, weight))


def flow_warp_case(dtype, gen):
    b, c, h, w = FLOW_WARP_SHAPE
    image = torch.randn((b, c, h, w), generator=gen)
    flow = 8.0 * torch.randn((b, 2, h, w), generator=gen)  # past the borders too
    return tuple(t.to(DEV, dtype) for t in (image, flow))


def corr_case(shape, gen):
    return tuple(torch.randn(shape, generator=gen).to(DEV) for _ in range(2))


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def upcast(args):
    return [tuple(v.float() for v in a) if isinstance(a, tuple) else a.float()
            for a in args]


def compare(name, kernel, plain, args, dtype):
    got = kernel(*args).float()
    torch.cuda.synchronize()
    want = plain(*upcast(args))
    err = (got - want).abs()
    tol = TOL[(name, dtype)]
    bound = tol["atol"] + tol["rtol"] * want.abs()
    bad = int((err > bound).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(
            f"{name} {tuple(args[0].shape)} {dtype}: {bad} elements outside "
            f"{tol}, max abs err {float(err.max()):.3g}"
        )
    return float(err.max())


def time_ms(fn, args) -> float:
    """Mean device time of one call, from CUDA events over many calls."""
    for _ in range(2):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    reps = min(200, max(3, math.ceil(100.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_engine(opt: Options, device, seed: int) -> InferenceEngine:
    """An engine with weights from a seeded torch.Generator and seeded
    running stats (mean N(0, 0.1), var U(0.5, 1.5))."""
    eng = InferenceEngine(opt, device=device)
    gen = torch.Generator().manual_seed(seed)  # on the CPU for every device
    init_weights(eng.gen, gen)
    with torch.no_grad():
        for m in eng.gen.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))
    return eng


def seeded_flow_estimator(device, seed: int, tf32_seen: list) -> FlowEstimator:
    """FlowEstimator with the reference flow nets' initialisation drawn
    from a seeded torch.Generator (on the CPU for every device). Each
    forward of its FlowNet2 appends cuDNN's TF32 flag to `tf32_seen`."""
    est = FlowEstimator()
    init_flownet_weights(est, torch.Generator().manual_seed(seed))
    est.net.register_forward_pre_hook(
        lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))
    return est.to(device).eval()


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default TF32 flags (cuDNN on, matmul off) for the block, so
    a FlowEstimator phase measures the precision the module sets itself."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def check_f32_convs(tf32_seen: list) -> None:
    """FlowNet2 ran with TF32 off although the caller had cuDNN's on."""
    if not tf32_seen or any(tf32_seen) or not torch.backends.cudnn.allow_tf32:
        raise AssertionError(
            f"cuDNN TF32 inside FlowNet2 {tf32_seen}, after the call "
            f"{torch.backends.cudnn.allow_tf32}: want False inside, True after")


def frame_pairs(t: int, h: int, w: int, seed: int = 0):
    """(1, T, 3, H, W) frame pairs from numpy: each next frame is the last
    one shifted by a few pixels plus small noise, values in [0, 1]."""
    rng = np.random.default_rng(seed)
    frames = [rng.random((3, h, w), dtype=np.float32)]
    for _ in range(t):
        moved = np.roll(frames[-1], (2, 3), axis=(1, 2))
        noise = 0.02 * rng.standard_normal((3, h, w), dtype=np.float32)
        frames.append(np.clip(moved + noise, 0.0, 1.0))
    stack = torch.from_numpy(np.stack(frames))
    return stack[None, :-1].contiguous(), stack[None, 1:].contiguous()


def label_stream(opt: Options, frames: int, h: int, w: int):
    """Labels and instances from numpy seed 0, as bench.py makes them."""
    rng = np.random.default_rng(0)
    n = frames + opt.n_frames_G - 1
    labels = torch.from_numpy(rng.integers(0, opt.label_nc, (1, n, h, w)))
    inst = torch.from_numpy(rng.integers(0, 4, (1, n, h, w)))
    return labels, inst


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = smi()

    # 1. device
    say("device", kind=repr(kind), smi=repr(card), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", lib=lib_path.name)

    # 3. kernels vs plain at the paths' shapes
    gen = torch.Generator().manual_seed(0)
    errs = {name: {} for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for c, h, w, _ in RESPAIR_SHAPES:
            args = respair_case(c, h, w, dtype, gen)
            e = compare("respair", respair, respair_plain, args, dtype)
            errs["respair"][dtype] = max(errs["respair"].get(dtype, 0.0), e)
            say("check", kernel="respair", shape=f"{c}x{h}x{w}",
                dtype=str(dtype)[6:], max_abs_err=f"{e:.3g}", ok=True)
        for h, w in WARP_SHAPES:
            args = warp_case(h, w, dtype, gen)
            e = compare("warp_blend", warp_blend, warp_blend_plain, args, dtype)
            errs["warp_blend"][dtype] = max(errs["warp_blend"].get(dtype, 0.0), e)
            say("check", kernel="warp_blend", shape=f"3x{h}x{w}",
                dtype=str(dtype)[6:], max_abs_err=f"{e:.3g}", ok=True)
        args = flow_warp_case(dtype, gen)
        e = compare("flow_warp", flow_warp, flow_warp_plain, args, dtype)
        errs["flow_warp"][dtype] = e
        say("check", kernel="flow_warp", shape="x".join(map(str, FLOW_WARP_SHAPE)),
            dtype=str(dtype)[6:], max_abs_err=f"{e:.3g}", ok=True)
        del args
    for shape in CORR_SHAPES:
        args = corr_case(shape, gen)
        e = compare("correlation", correlation, correlation_plain, args, torch.float32)
        errs["correlation"][torch.float32] = max(
            errs["correlation"].get(torch.float32, 0.0), e)
        say("check", kernel="correlation", shape="x".join(map(str, shape)),
            dtype="float32", max_abs_err=f"{e:.3g}", ok=True)
        del args

    # 4. small-input reference: card (kernels) vs CPU (plain), f32
    opt_s = Options(**SMALL)
    h_s, w_s = 64, 256
    labels, inst = label_stream(opt_s, 3, h_s, w_s)
    engines = {d: seeded_engine(opt_s, d, seed=1) for d in ("cpu", DEV)}
    frames = {}
    for d, eng in engines.items():
        state = eng.initial_state(1, h_s, w_s)
        outs = []
        for t in range(3):
            f, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
            outs.append(f.cpu())
        frames[d] = torch.stack(outs, 1)
    small_err = float((frames[DEV] - frames["cpu"]).abs().max())
    if not small_err <= 2e-3:
        raise AssertionError(f"small reference: card vs CPU max abs err {small_err}")
    say("reference", config="small 64x256 f32", frames=3,
        max_abs_err=f"{small_err:.3g}", bound=2e-3, ok=True)
    del engines, frames

    # 4b. FlowEstimator on one (B=1, T=2) pair stack at 96x160 (the //64
    # resize round trip): card vs CPU, same weights, f32; the bounds of
    # tests/test_flownet2_oracle.py:406-410. PyTorch's default TF32 flags:
    # the estimator turns cuDNN's TF32 off itself
    im1, im2 = frame_pairs(2, 96, 160, seed=1)
    outs, tf32_seen = {}, []
    for d in ("cpu", DEV):
        est = seeded_flow_estimator(d, seed=1, tf32_seen=tf32_seen)
        with torch_default_tf32():
            outs[d] = [t.cpu() for t in est(im1.to(d), im2.to(d))]
            check_f32_convs(tf32_seen)
    flow_err = float((outs[DEV][0] - outs["cpu"][0]).abs().max())
    conf_ok = float(((outs[DEV][1] - outs["cpu"][1]).abs() < 1e-3).float().mean())
    if not (flow_err <= 2e-3 and conf_ok >= 0.99):
        raise AssertionError(
            f"FlowEstimator reference: flow max abs err {flow_err} (bound 2e-3), "
            f"conf share within 1e-3 {conf_ok} (bound 0.99)")
    say("reference", config="FlowEstimator 96x160 (1, 2) f32",
        flow_max_abs_err=f"{flow_err:.3g}", flow_bound=2e-3,
        conf_share_within_1e3=f"{conf_ok:.5f}", conf_bound=0.99,
        flow_abs_max=f"{float(outs['cpu'][0].abs().max()):.3g}",
        conf_mean=f"{float(outs['cpu'][1].mean()):.4g}", ok=True)
    del est, outs

    # 5. the main path at full width
    opt = Options(**FLAGSHIP)
    h, w, n_frames, warm = 1024, 2048, 8, 2
    t0 = time.perf_counter()
    eng = seeded_engine(opt, DEV, seed=0)
    labels, inst = label_stream(opt, n_frames, h, w)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = eng.initial_state(1, h, w)
    torch.cuda.reset_peak_memory_stats()
    times, fakes = [], []
    reset_launches()
    for t in range(n_frames):
        t1 = time.perf_counter()
        fake, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state,
                               use_raw_only=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        fakes.append(fake)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for fake in fakes:
        if fake.shape != (1, 3, h, w) or fake.dtype != torch.float32:
            raise AssertionError(f"frame {tuple(fake.shape)} {fake.dtype}")
        if not torch.isfinite(fake).all():
            raise AssertionError("non-finite frame")
        if float(fake.abs().max()) > 1 + 1e-2:
            raise AssertionError(f"|fake| {float(fake.abs().max())} > 1 + 1e-2")
    want = {"respair": 45 * n_frames, "warp_blend": 3 * n_frames,
            "flow_warp": 0, "correlation": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    say("main_path", config="label2city 2048x1024 3-scale ngf128 fg bf16",
        frames=n_frames, setup_s=f"{setup_s:.1f}",
        ms_per_frame_median=f"{statistics.median(times[warm:]):.2f}",
        ms_per_frame=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        card=repr(card))
    del eng, fakes, state
    torch.cuda.empty_cache()

    # 5b. the FlowNet2 path at full width: FlowEstimator in f32 on (1, 2)
    # pairs of 1024x2048 frames, what Trainer.flow_fn gets per chunk at
    # max_frames_per_gpu=2; PyTorch's default TF32 flags, as in 4b
    h, w, n_calls, warm = 1024, 2048, 5, 1
    t0 = time.perf_counter()
    tf32_seen = []
    est = seeded_flow_estimator(DEV, seed=0, tf32_seen=tf32_seen)
    im1, im2 = (t.to(DEV) for t in frame_pairs(2, h, w, seed=0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, results = [], []
    with torch_default_tf32():
        for _ in range(n_calls):
            t1 = time.perf_counter()
            flow, conf = est(im1, im2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            results.append((flow, conf))
        check_f32_convs(tf32_seen)
        caller_tf32 = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
    flow_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for flow, conf in results:
        if flow.shape != (1, 2, 2, h, w) or conf.shape != (1, 2, 1, h, w):
            raise AssertionError(f"flow {tuple(flow.shape)}, conf {tuple(conf.shape)}")
        if not (torch.isfinite(flow).all() and torch.isfinite(conf).all()):
            raise AssertionError("non-finite flow or confidence")
        if float(conf.min()) < 0.0 or float(conf.max()) > 1.0:
            raise AssertionError("confidence outside [0, 1]")
    want = {"respair": 0, "warp_blend": 0, "flow_warp": 5 * n_calls,
            "correlation": n_calls}
    if flow_launches != want:
        raise AssertionError(f"launch counts {flow_launches}, want {want}")
    med = statistics.median(times[warm:])
    flow = results[-1][0]
    say("flownet2_path", config="FlowEstimator FlowNet2 1024x2048 (B=1, T=2) f32",
        calls=n_calls, setup_s=f"{setup_s:.1f}",
        ms_per_call_median=f"{med:.2f}", ms_per_pair_median=f"{med / 2:.2f}",
        ms_per_call=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(flow_launches),
        flow_abs_max=f"{float(flow.abs().max()):.4g}",
        flow_abs_mean=f"{float(flow.abs().mean()):.4g}",
        conf_mean=f"{float(results[-1][1].mean()):.4g}",
        caller_cudnn_allow_tf32=caller_tf32[0], caller_matmul_allow_tf32=caller_tf32[1],
        net_cudnn_allow_tf32=tf32_seen[0], card=repr(card))
    launches.update(flow_warp=flow_launches["flow_warp"],
                    correlation=flow_launches["correlation"])
    del est, results, flow, conf, im1, im2
    torch.cuda.empty_cache()

    # 6. kernel and plain times at the paths' shapes
    ms = {name: [0.0, 0.0] for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for c, h, w, n in RESPAIR_SHAPES:
            args = respair_case(c, h, w, dtype, gen)
            k, p = time_ms(respair, args), time_ms(respair_plain, args)
            if dtype == torch.bfloat16:
                ms["respair"][0] += n * k
                ms["respair"][1] += n * p
            say("time", kernel="respair", shape=f"{c}x{h}x{w}", dtype=str(dtype)[6:],
                ms=f"{k:.4f}", plain_ms=f"{p:.4f}", calls_per_frame=n)
        for h, w in WARP_SHAPES:
            args = warp_case(h, w, dtype, gen)
            k, p = time_ms(warp_blend, args), time_ms(warp_blend_plain, args)
            if dtype == torch.bfloat16:
                ms["warp_blend"][0] += k
                ms["warp_blend"][1] += p
            say("time", kernel="warp_blend", shape=f"3x{h}x{w}", dtype=str(dtype)[6:],
                ms=f"{k:.4f}", plain_ms=f"{p:.4f}", calls_per_frame=1)
        args = flow_warp_case(dtype, gen)
        k, p = time_ms(flow_warp, args), time_ms(flow_warp_plain, args)
        if dtype == torch.float32:
            ms["flow_warp"] = [5 * k, 5 * p]
        say("time", kernel="flow_warp", shape="x".join(map(str, FLOW_WARP_SHAPE)),
            dtype=str(dtype)[6:], ms=f"{k:.4f}", plain_ms=f"{p:.4f}",
            calls_per_flow_call=5)
        del args
    for i, shape in enumerate(CORR_SHAPES):
        args = corr_case(shape, gen)
        k, p = time_ms(correlation, args), time_ms(correlation_plain, args)
        if i == 0:
            ms["correlation"] = [k, p]
        flop = 2.0 * shape[0] * shape[2] * shape[3] * 441 * shape[1]
        say("time", kernel="correlation", shape="x".join(map(str, shape)),
            dtype="float32", ms=f"{k:.4f}", plain_ms=f"{p:.4f}",
            tflops=f"{flop / k / 1e9:.2f}", calls_per_flow_call=int(i == 0))
        del args

    sources = {
        "respair": ("vid2vid_tpu_torch/csrc/respair.cu",
                    "vid2vid_tpu/ops/respair_pallas.py:79",
                    "bf16, summed over one 2048x1024 label2city frame's 45 calls"),
        "warp_blend": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                       "vid2vid_tpu/ops/warp.py:271",
                       "bf16, summed over one 2048x1024 label2city frame's 3 calls"),
        "flow_warp": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                      "vid2vid_tpu/ops/warp.py:271",
                      "f32, summed over one FlowEstimator call's 5 launches at "
                      "(2, 3, 1024, 2048)"),
        "correlation": ("vid2vid_tpu_torch/csrc/correlation.cu",
                        "vid2vid_tpu/ops/correlation_pallas.py:35",
                        "f32, one FlowEstimator call's one launch at "
                        "(2, 256, 128, 256)"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": errs[name][torch.float32],
         "max_abs_err_bf16": errs[name].get(torch.bfloat16),
         "ms": ms[name][0], "plain_ms": ms[name][1], "ms_is": ms_is}
        for name, (src, rep, ms_is) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
