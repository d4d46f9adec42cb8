"""Time the warp forward kernel (csrc/warp_blend.cu) under candidate plans at
the paths' shapes, for both flow kinds, on one card: the measurements
behind ops/warp.py::warp_forward_plan.

A plan is a tile of rows x columns and a box budget (the shared memory a
block may stage its box of prev in, 4 pixels a thread; 0: every tile
gathers from device memory, 2 pixels a thread). For each (entry, dtype,
shape) of SHAPES, each flow kind (`iid`: 8 * N(0, 1) pixels a pixel,
chip_smoke.py's yardstick; `smooth`: the same scale drawn every 16 pixels
and upsampled bilinearly, as the paths' flows are smooth) and each plan the
kernel takes, it prints one JSON line: the device ms of a launch (calls of
ops/warp.py::warp_forward_cuda captured in a CUDA graph, its replays timed
with CUDA events, after a warm-up) and the share of tiles the launch staged
(its own count). Then, per (entry, dtype, shape, flow), the fastest plan
beside the plan warp_forward_plan picks, and last the card's name and
power limit.

With `--flownet2` it times, instead, the flows FlowNet2 itself warps by:
one call of a seeded FlowEstimator (random weights from one seed, a pair of
1024x2048 frames, each the last shifted by (2, 3) pixels plus noise) with
every flow_warp launch's operands recorded; then, for each launch, its
flow's size and roughness, its staged share under the plan that stages,
and the device ms of the launch under the direct plan and under the staged
plan, in turns (direct, staged, staged, direct); last, the whole call with
each plan forced, in the same turns (host ms, median of 8 calls a turn).

Run on a machine with an NVIDIA Hopper card:

    python -m vid2vid_tpu_torch.tools.warp_plans [--out FILE] [--flownet2]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess

import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from vid2vid_tpu_torch.ops import warp
from vid2vid_tpu_torch.ops.warp import (
    WarpPlan, plan_threads, staged_tiles, tile_plan, warp_forward_cuda, warp_forward_plan,
)

# (entry, dtype, (B, C, H, W)): the flagship frame's three blends (bf16;
# the smallest is also the training chunk's), the F_Warp warp of the
# training chunk, the same at 1024x512, and FlowNet2's warps (f32)
SHAPES = [
    ("warp_blend", torch.bfloat16, (1, 3, 256, 512)),
    ("warp_blend", torch.bfloat16, (1, 3, 512, 1024)),
    ("warp_blend", torch.bfloat16, (1, 3, 1024, 2048)),
    ("flow_warp", torch.float32, (2, 3, 256, 512)),
    ("flow_warp", torch.float32, (2, 3, 512, 1024)),
    ("flow_warp", torch.float32, (2, 3, 1024, 2048)),
]
TILES = [(1, 512), (8, 32), (16, 32), (32, 32), (8, 64), (16, 64), (4, 128)]
BUDGETS = [0, 16 * 1024, 32 * 1024, 48 * 1024]
GRAPH_LAUNCHES = 20


def iid_flow(b: int, h: int, w: int, gen: torch.Generator, scale: float = 8.0) -> torch.Tensor:
    """(B, 2, H, W) flow of `scale` * N(0, 1) pixels drawn for every pixel:
    neighbours sample unrelated points."""
    return scale * torch.randn((b, 2, h, w), generator=gen)


def smooth_flow(b: int, h: int, w: int, gen: torch.Generator, scale: float = 8.0,
                cell: int = 16) -> torch.Tensor:
    """(B, 2, H, W) flow of `scale` * N(0, 1) pixels drawn on a grid of one
    point every `cell` pixels and upsampled bilinearly: neighbours sample
    neighbouring points, as in the flows the paths warp by (FlowNet2's, the
    generator's flow head)."""
    coarse = scale * torch.randn((b, 2, h // cell + 2, w // cell + 2), generator=gen)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)


FLOWS = {"iid": iid_flow, "smooth": smooth_flow}


def plans(c: int, dtype: torch.dtype, h: int, w: int) -> list[WarpPlan]:
    """Every candidate plan the kernel takes at this shape (plan_threads),
    with a budget no larger than the frame's C planes (a larger one stages
    nothing more)."""
    base = warp_forward_plan(c, dtype, h, w, w)
    frame = c * h * math.ceil(w / base.align) * base.align * dtype.itemsize
    candidates = (WarpPlan(rows, cols, budget, base.align) for rows, cols in TILES
                  for budget in sorted({min(b, frame) for b in BUDGETS}))
    return [plan for plan in candidates if plan_threads(plan)]


def time_launch(fn) -> float:
    """Device ms of one call of fn (one launch of the entry):
    GRAPH_LAUNCHES calls captured in one CUDA graph (no host time between
    them), its replays timed with CUDA events (enough for ~30 ms), after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    reps = min(200, max(3, math.ceil(30.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * GRAPH_LAUNCHES)


def sweep() -> list[dict]:
    dev = torch.device("cuda")
    rows = []
    for entry, dtype, (b, c, h, w) in SHAPES:
        gen = torch.Generator().manual_seed(0)
        raw, prev = (torch.randn((b, c, h, w), generator=gen).to(dev, dtype) for _ in range(2))
        weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=gen)).to(dev, dtype)
        blend = (raw, weight) if entry == "warp_blend" else (None, None)
        staged = torch.zeros(1, dtype=torch.int32, device=dev)
        for kind, make in FLOWS.items():
            flow = make(b, h, w, torch.Generator().manual_seed(1)).to(dev, dtype)
            for plan in plans(c, dtype, h, w):
                staged.zero_()
                warp_forward_cuda(prev, flow, *blend, -1, plan, staged)
                tiles = b * math.ceil(h / plan.rows) * math.ceil(w / plan.cols)
                share = int(staged) / tiles
                ms = time_launch(lambda: warp_forward_cuda(prev, flow, *blend, -1, plan))
                row = dict(entry=entry, dtype=str(dtype)[6:], shape=[b, c, h, w], flow=kind,
                           rows=plan.rows, cols=plan.cols, pix=plan.pix,
                           smem_bytes=plan.smem_bytes, ms=ms, staged_share=share)
                rows.append(row)
                print(json.dumps(row), flush=True)
    for entry, dtype, shape in SHAPES:
        pick = warp_forward_plan(shape[1], dtype, shape[2], shape[3], shape[3])
        for kind in FLOWS:
            mine = [r for r in rows if r["entry"] == entry and r["shape"] == list(shape)
                    and r["dtype"] == str(dtype)[6:] and r["flow"] == kind]
            best = min(mine, key=lambda r: r["ms"])
            picked = next((r for r in mine if (r["rows"], r["cols"], r["smem_bytes"], r["pix"])
                           == (pick.rows, pick.cols, pick.smem_bytes, pick.pix)), None)
            print(json.dumps(dict(summary=entry, dtype=str(dtype)[6:], shape=list(shape),
                                  flow=kind, best=best,
                                  picked_ms=picked and picked["ms"],
                                  picked=pick._asdict())), flush=True)
    return rows


def frame_pair(h: int, w: int, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, 3, H, W) frames from numpy: values in [0, 1], the second the
    first shifted by (2, 3) pixels plus small noise."""
    rng = np.random.default_rng(seed)
    first = rng.random((3, h, w), dtype=np.float32)
    noise = 0.02 * rng.standard_normal((3, h, w), dtype=np.float32)
    second = np.clip(np.roll(first, (2, 3), axis=(1, 2)) + noise, 0.0, 1.0)
    return torch.from_numpy(first)[None], torch.from_numpy(second)[None]


@contextlib.contextmanager
def forced_plan(plan: WarpPlan):
    """ops.warp's plan rule replaced, inside the block, by one that always
    returns `plan`."""
    rule = warp.warp_forward_plan
    warp.warp_forward_plan = lambda *_: plan
    try:
        yield
    finally:
        warp.warp_forward_plan = rule


def flownet2(seed: int = 0, h: int = 1024, w: int = 2048) -> list[dict]:
    """The direct and the staged plan on the flows of one FlowEstimator
    call (see the module's docstring); one JSON line a launch, then one for
    the call."""
    from vid2vid_tpu_torch.models.flownet2.nets import init_flownet_weights
    from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator

    dev = torch.device("cuda")
    est = FlowEstimator()
    init_flownet_weights(est, torch.Generator().manual_seed(seed))
    est = est.to(dev).eval()
    im1, im2 = (t.to(dev) for t in frame_pair(h, w, seed))
    launches = []
    record = warp.warp_forward_cuda

    def recording(prev, flow, *args, **kwargs):
        launches.append((prev.clone(), flow.clone()))
        return record(prev, flow, *args, **kwargs)

    warp.warp_forward_cuda = recording
    try:
        est(im1, im2)
    finally:
        warp.warp_forward_cuda = record
    staged_plan = warp_forward_plan(3, torch.float32, h, w, w)
    plans = {"direct": tile_plan(torch.float32, staged=False), "staged": staged_plan}
    order = ("direct", "staged", "staged", "direct")
    rows = []
    for i, (prev, flow) in enumerate(launches):
        b, c, fh, fw = prev.shape
        plan = warp_forward_plan(c, prev.dtype, fh, fw, fw)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        warp_forward_cuda(prev, flow, plan=plan, staged=count)
        tiles = b * math.ceil(fh / plan.rows) * math.ceil(fw / plan.cols)
        mag = flow.norm(dim=1)
        step = (flow[..., 1:] - flow[..., :-1]).abs().mean()
        ms = {k: [] for k in plans}
        for k in order:
            ms[k].append(time_launch(lambda: warp_forward_cuda(prev, flow, plan=plans[k])))
        row = dict(launch=i, shape=[b, c, fh, fw], plan=plan._asdict(),
                   staged_share=int(count) / tiles,
                   staged_share_mirror=staged_tiles(flow, plan, c) / tiles,
                   flow_px_mean=float(mag.mean()), flow_px_max=float(mag.max()),
                   flow_step_px_mean=float(step),
                   ms_direct=statistics.mean(ms["direct"]),
                   ms_staged=statistics.mean(ms["staged"]), ms_turns=ms)
        rows.append(row)
        print(json.dumps(row), flush=True)
    calls = {k: [] for k in plans}
    for k in order:
        with forced_plan(plans[k]):
            est(im1, im2)
            torch.cuda.synchronize()
            times = []
            for _ in range(8):
                t0 = time.perf_counter()
                est(im1, im2)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        calls[k].append(statistics.median(times))
    total = dict(flownet2_call_ms=calls, launches=len(launches),
                 warps_ms_direct=sum(r["ms_direct"] for r in rows),
                 warps_ms_staged=sum(r["ms_staged"] for r in rows))
    rows.append(total)
    print(json.dumps(total), flush=True)
    return rows


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write every row to this JSON file")
    parser.add_argument("--flownet2", action="store_true",
                        help="time the direct and the staged plan on FlowNet2's own flows")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warp_plans: needs a CUDA card")
    rows = flownet2() if args.flownet2 else sweep()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
