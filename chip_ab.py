"""Time the correlation backward, FlowNetC's training step, the warp
forwards, the FlowEstimator call, or the flagship streamed frame, of
several checkouts of this repository on one card, in turns, so that two
commits compare on one machine.

Each checkout runs in its own process, through its own chip_smoke.py's
helpers, and builds its own kernels under its own build/ the first time:
  - the backward (default): phase 6's `corr_bwd_case` and `time_ms` (the
    same seeded operands, CUDA events over many calls) at SHAPES;
  - `--flow-train`: phase 9's FlowNetC at batch 8 on 384x512 pairs
    (`flow_pairs`, `seeded_flownet_c`, `timed_steps`), f32 with TF32 off
    and bf16, 5 warm-up and 10 timed steps each, ms a step (host clock);
    then one profiled step (`profile_by_family`): its kernels' device ms
    and the correlation backward's;
  - `--warp`: phase 6's warp forward cases, `warp_blend` at the flagship
    frame's three shapes and `flow_warp` at FlowNet2's (2, 3, 1024, 2048),
    each in bf16 and f32, on both flow kinds (`iid`: 8 px a pixel;
    `smooth`: 8 px every 16 pixels, upsampled bilinearly), drawn here from
    one seed so every checkout warps the same inputs; ms a call (events
    over 200 back-to-back calls) and device ms (the profiler), by
    `call_and_device_ms`;
  - `--flow-estimator`: phase 5b's FlowEstimator (FlowNet2, f32, on (1,
    2) pairs of 1024x2048 frames, `seeded_flow_estimator`, `frame_pairs`,
    PyTorch's default TF32 flags), 2 warm-up and 10 timed calls, ms a call
    (host clock around torch.cuda.synchronize()), then one profiled call:
    its kernels' device ms by family (`profile_by_family`);
  - `--frame`: phase 5's flagship frame, label2city 2048x1024 bf16
    (`seeded_engine`, `label_stream`, FLAGSHIP), through
    InferenceEngine.step: 3 warm-up and 20 timed frames, ms a frame (host
    clock around torch.cuda.synchronize()). After the runs, one process
    times the host cost of calling an operator on a CUDA tensor, 20000
    calls each, by three routes to the same body: a Python function, an
    operator of `torch.library.Library(.., "DEF")` with a CUDA `impl` (the
    port's registration, ops/library.py), and a `torch.library.custom_op`.
Run from the root of a checkout on a machine with one NVIDIA Hopper card,
e.g. with the parent commit unpacked (git archive) under the ignored
build/parent:

    python3 chip_ab.py build/parent . . build/parent
    python3 chip_ab.py --flow-train build/parent . . build/parent
    python3 chip_ab.py --frame build/parent . . build/parent
    python3 chip_ab.py --warp build/parent . . build/parent
    python3 chip_ab.py --flow-estimator build/parent . . build/parent

One JSON line per run ({"root", "ms": ...}) (with --frame, then one with
the three routes' microseconds a call), then the card's name and power
limit, then one JSON line with every run in order.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# FlowNetC's training shape (batch 8 of 384x512 pairs) and chip_smoke.py's
# CORR_BWD_TIMED
SHAPES = [(8, 256, 48, 64), (2, 256, 64, 128), (2, 256, 32, 64)]

# each runs in the checkout's root, so that its chip_smoke and package import
CHILD_BWD = """
import json, sys
import torch
import chip_smoke as cs
ms = {}
for shape in json.loads(sys.argv[1]):
    args = cs.corr_bwd_case(tuple(shape), torch.Generator().manual_seed(0))
    ms["x".join(map(str, shape))] = cs.time_ms(cs.correlation_bwd, args)
    del args
print(json.dumps(ms))
"""
CHILD_FLOW_TRAIN = """
import json, statistics
import torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
pair, flow = cs.flow_pairs(cs.FLOW_TRAIN_BATCH, *cs.FLOW_TRAIN_HW, seed=0)
ms = {}
for mode, mixed in (("f32", False), ("bf16", True)):
    harness = cs.FlowHarness(cs.seeded_flownet_c(seed=0), mixed_precision=mixed, device=cs.DEV)
    with cs.torch_default_tf32():
        cs.timed_steps(harness, pair, flow, 5)
        steps = cs.timed_steps(harness, pair, flow, 10)
        fams, busy, _ = cs.profile_by_family(lambda: harness.train_step(pair, flow),
                                             f"FlowNetC {mode} step")
    ms[mode] = statistics.median(steps)
    ms[mode + "_steps"] = [round(v, 3) for v in steps]
    ms[mode + "_kernel_ms"] = busy
    ms[mode + "_correlation_bwd_ms"] = dict((f, t) for f, t, _ in fams).get(
        "correlation backward (ours)", 0.0)
    del harness
    torch.cuda.empty_cache()
print(json.dumps(ms))
"""
CHILD_WARP = """
import json
import torch
import torch.nn.functional as F
import chip_smoke as cs

def flow(kind, b, h, w, gen):
    if kind == "iid":
        return 8.0 * torch.randn((b, 2, h, w), generator=gen)
    coarse = 8.0 * torch.randn((b, 2, h // 16 + 2, w // 16 + 2), generator=gen)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)

ms = {}
cases = [("warp_blend", (1, 3, h, w)) for h, w in ((256, 512), (512, 1024), (1024, 2048))]
cases.append(("flow_warp", (2, 3, 1024, 2048)))
for kind in ("iid", "smooth"):
    for dtype in (torch.bfloat16, torch.float32):
        for name, (b, c, h, w) in cases:
            gen = torch.Generator().manual_seed(0)
            image = torch.randn((b, c, h, w), generator=gen)
            fl = flow(kind, b, h, w, gen)
            if name == "warp_blend":
                raw = torch.randn((b, c, h, w), generator=gen)
                weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=gen))
                args, fn = (raw, image, fl, weight), cs.warp_blend
            else:
                args, fn = (image, fl), cs.flow_warp
            args = tuple(t.to(cs.DEV, dtype) for t in args)
            key = " ".join((name, str(dtype)[6:], "x".join(map(str, (b, c, h, w))), kind))
            ms[key] = cs.call_and_device_ms(fn, args)
            del args
print(json.dumps(ms))
"""
CHILD_FLOW_ESTIMATOR = """
import json, statistics, time
import torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
est = cs.seeded_flow_estimator(cs.DEV, seed=0, tf32_seen=[])
im1, im2 = (t.to(cs.DEV) for t in cs.frame_pairs(2, 1024, 2048, seed=0))
times = []
with cs.torch_default_tf32():
    for _ in range(12):
        t1 = time.perf_counter()
        est(im1, im2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
timed = times[2:]
with cs.torch_default_tf32():
    fams, busy, wall = cs.profile_by_family(lambda: est(im1, im2), "FlowEstimator call")
print(json.dumps({"median": statistics.median(timed), "min": min(timed), "max": max(timed),
                  "calls": [round(v, 3) for v in timed], "kernel_ms": busy,
                  "families_ms": {f: t for f, t, _ in fams}}))
"""
CHILD_FRAME = """
import json, statistics, time
import torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
opt = cs.Options(**cs.FLAGSHIP)
(h, w), n_warm, n_timed = cs.CITY_HW, 3, 20
eng = cs.seeded_engine(opt, cs.DEV, seed=0)
labels, inst = cs.label_stream(opt, n_warm + n_timed, h, w)
state = eng.initial_state(1, h, w)
times = []
for t in range(n_warm + n_timed):
    t1 = time.perf_counter()
    _, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t1) * 1e3)
timed = times[n_warm:]
print(json.dumps({"median": statistics.median(timed), "mean": statistics.mean(timed),
                  "min": min(timed), "max": max(timed), "frames": [round(v, 3) for v in timed]}))
"""
CHILD_DISPATCH = """
import json, time
import torch
body = lambda x: torch.empty_like(x)
lib = torch.library.Library("v2v_dispatch_ab", "DEF")
lib.define("op(Tensor x) -> Tensor")
lib.impl("op", body, "CUDA")
@torch.library.custom_op("v2v_dispatch_ab2::op", mutates_args=(), device_types="cuda")
def custom(x: torch.Tensor) -> torch.Tensor:
    return body(x)
x = torch.zeros(8, device="cuda")
us = {}
for name, fn in (("python", body), ("library_def", torch.ops.v2v_dispatch_ab.op.default),
                 ("custom_op", custom)) * 2:
    for _ in range(1000):
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20000):
        fn(x)
    torch.cuda.synchronize()
    us[name] = (time.perf_counter() - t0) / 20000 * 1e6
print(json.dumps(us))
"""


def run(root: str, child: str) -> dict:
    out = subprocess.run([sys.executable, "-c", child, json.dumps(SHAPES)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"chip_ab: {root} failed ({out.returncode}):\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(args: list[str]) -> None:
    modes = {"--flow-train": CHILD_FLOW_TRAIN, "--frame": CHILD_FRAME, "--warp": CHILD_WARP,
             "--flow-estimator": CHILD_FLOW_ESTIMATOR}
    roots = [a for a in args if a not in modes]
    if not roots:
        raise SystemExit(__doc__)
    child = next((modes[a] for a in args if a in modes), CHILD_BWD)
    runs = []
    for root in roots:
        runs.append({"root": root, "ms": run(os.path.abspath(root), child)})
        print(json.dumps(runs[-1]), flush=True)
    if child is CHILD_FRAME:
        print(json.dumps({"dispatch_us_per_call": run(os.getcwd(), CHILD_DISPATCH)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main(sys.argv[1:])
