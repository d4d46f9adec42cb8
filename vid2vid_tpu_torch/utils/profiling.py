"""Profiling and tracing on torch.profiler (the port of
vid2vid_tpu/utils/profiling.py).

- `trace(log_dir, device)`: a torch.profiler window over the block (CPU,
  and CUDA activity on a CUDA device) that writes a Chrome trace
  (`*.pt.trace.json.gz`) under log_dir, for TensorBoard or Perfetto.
- `summarize_trace(log_dir)`: the newest trace's device kernels summed by
  family (`FAMILIES`), the largest first.
- `device_memory_stats()`: `torch.cuda.memory_stats` of each visible card,
  with JAX's `bytes_in_use` / `bytes_limit` beside them (--debug).
- `StepTimer`: a rolling wall-clock step time; `stop` synchronizes the card.
- `profile_once` / `profile_by_family`: one step's kernels by family from
  `key_averages()`, held to the port's launch counters (`COUNTERS`), with a
  window recorded anew when the profiler drops one of our kernels.

Two habits of the profiler on the H100, which the windows here work
around: without a warm-up step it loses the first kernels of a window, and
a window whose first kernel comes from our library through ctypes (not
PyTorch's runtime) loses that kernel; `open_window` / `close_window` put a
PyTorch fill at both ends.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time

import torch

from vid2vid_tpu_torch.ops.conv3 import conv3_fused_padded, conv3_padded
from vid2vid_tpu_torch.ops.conv7 import conv7_padded, conv7_reflect
from vid2vid_tpu_torch.ops.correlation import correlation, correlation_bwd
from vid2vid_tpu_torch.ops.respair import respair
from vid2vid_tpu_torch.ops.warp import flow_warp, flow_warp_bwd, warp_blend, warp_blend_bwd

# the launch counters of each kernel (conv7 has two entries)
COUNTERS = {
    "respair": (respair,), "warp_blend": (warp_blend,), "flow_warp": (flow_warp,),
    "correlation": (correlation,), "correlation_bwd": (correlation_bwd,),
    "warp_blend_bwd": (warp_blend_bwd,), "flow_warp_bwd": (flow_warp_bwd,),
    "conv7": (conv7_reflect, conv7_padded), "conv3": (conv3_padded,),
    "conv3_fused": (conv3_fused_padded,),
}

FAMILIES = [  # (family, pattern searched in the lowercased kernel name), first match wins
    # conv_wgmma_kernel<F32, 3, BN, RW, REFLECT, CL> (csrc/conv_wgmma.cuh,
    # bf16 and f32): respair's launches are the reflect ones
    ("respair (ours)", r"conv_wgmma_kernel<\w+, 3, \d+, \d+, true,"),
    ("conv7 (ours)", r"conv7x7_kernel<|conv_wgmma_kernel<\w+, 7,"),
    ("conv3 / conv3_fused (ours)", r"conv_wgmma_kernel<\w+, 3, \d+, \d+, false,"),
    ("warp kernels (ours)", r"warp_kernel|warp_bwd_kernel|splat_to_bf16_kernel"),
    ("correlation backward (ours)", r"correlation_bwd_kernel"),
    ("correlation (ours)", r"correlation_kernel|sum_parts_kernel"),
    ("memset (the warp backward's splat, others)", r"^memset"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"conv|cudnn|gemm|xmma|wgrad|dgrad|fprop|cutlass|winograd|implicit"),
    ("batch norm", r"batch_norm|batchnorm|bn_"),
    ("optimizer (Adam)", r"adam|multi_tensor"),
    ("reductions", r"reduce"),
    ("pool / resize", r"pool|upsample|grid_sampler|interpolate"),
    ("elementwise / copy / cat", r"elementwise|vectorized|copy|cat|fill|index|gather|scatter"),
]
# our families' counters, each with its kernels per counted launch
# (respair's wrapper launches the conv twice): the profiled launches of a
# family must equal their sum
OUR_FAMILIES = {
    "respair (ours)": {"respair": 2}, "conv7 (ours)": {"conv7": 1},
    "conv3 / conv3_fused (ours)": {"conv3": 1, "conv3_fused": 1},
    "warp kernels (ours)": dict.fromkeys(
        ("warp_blend", "flow_warp", "warp_blend_bwd", "flow_warp_bwd"), 1),
    "correlation (ours)": {"correlation": 1},
    "correlation backward (ours)": {"correlation_bwd": 1},
}
DEVICE_TIME = ("self_device_time_total", "self_cuda_time_total")


def family(kernel_name: str) -> str:
    """The family of a device kernel's name (`FAMILIES`), or "other"."""
    name = kernel_name.lower()
    return next((f for f, pattern in FAMILIES if re.search(pattern, name)), "other")


def read_launches() -> dict:
    """The counted launches of each kernel's wrapper(s)."""
    return {name: sum(fn.launches for fn in fns) for name, fns in COUNTERS.items()}


def read_kernels() -> dict:
    """The kernels each wrapper launched: its counted launches plus the
    second kernels some of them launch (the correlation's pass that adds a
    split channel sum, the warp backward's bf16 cast of its splat)."""
    return {name: sum(fn.launches + getattr(fn, "second_kernels", 0) for fn in fns)
            for name, fns in COUNTERS.items()}


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


# ------------------------------------------------------------------ traces


def open_window(device: torch.device | str = "cuda") -> None:
    """One PyTorch kernel (a fill) at the start of a profiler window: a
    window whose first kernel came from our library through ctypes lost
    that kernel."""
    torch.zeros(1, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def close_window(device: torch.device | str = "cuda") -> None:
    """The same fill at the end of a profiler window, then 2 ms of host
    time, so that no kernel of the recorded step ends near the window's
    end."""
    open_window(device)
    time.sleep(0.002)


@contextlib.contextmanager
def trace(log_dir: str, device: torch.device | str = "cuda"):
    """Profile the block: CPU activity, and CUDA activity when `device` is
    a CUDA device; writes `<host>_<pid>.<time>.pt.trace.json.gz` under
    log_dir. A warm-up step (one fill) comes first, and a fill at both ends
    of the recorded window (`open_window`). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True)) as prof:
        open_window(device)
        prof.step()
        open_window(device)
        yield prof
        close_window(device)
        prof.step()


def summarize_trace(log_dir: str, top: int = 20) -> list[tuple[str, float]]:
    """The newest trace under log_dir: its device kernels' (and memsets')
    time summed by family, [(family, ms)], the largest first. A CPU-only
    trace has none."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json.gz"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json.gz under {log_dir}")
    with gzip.open(max(paths, key=os.path.getmtime)) as fh:
        data = json.load(fh)
    groups: collections.Counter = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset"):
            groups[family(e["name"])] += e.get("dur", 0)
    return [(k, v / 1e3) for k, v in groups.most_common(top)]


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of each visible card, keyed "cuda:<i>",
    with `bytes_in_use` (allocated now), `peak_bytes_in_use` and
    `bytes_limit` (the card's memory) added; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        st = dict(torch.cuda.memory_stats(i))
        st["bytes_in_use"] = st.get("allocated_bytes.all.current", 0)
        st["peak_bytes_in_use"] = st.get("allocated_bytes.all.peak", 0)
        st["bytes_limit"] = torch.cuda.get_device_properties(i).total_memory
        stats[f"cuda:{i}"] = st
    return stats


class StepTimer:
    """Rolling average step time (seconds) over the last `window` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, barrier: torch.device | str | None = None) -> float:
        """The step's time; with `barrier` (a CUDA device) the card's work
        is waited for first."""
        if barrier is not None:
            torch.cuda.synchronize(barrier)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


# ----------------------------------------------------- kernels by family


def profile_once(fn, device: torch.device | str = "cuda") -> tuple[list, float, dict]:
    """One profiler window around fn on a CUDA device, after a warm-up step:
    (rows [(ms, count, family, kernel name)], wall ms, our families'
    launches by the counters) of the recorded step. Only the kernels' own
    rows count: an operator's row, and a user annotation's
    (Optimizer.step), repeat their kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize(device)
    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize(device)
        prof.step()
        open_window(device)
        before = read_kernels()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
        counted = read_kernels()
        close_window(device)
        prof.step()
    rows = []
    for evt in recorded[0]:
        us = next((getattr(evt, a) for a in DEVICE_TIME if hasattr(evt, a)), 0.0)
        if (us <= 0 or evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or evt.key.startswith(("Command Buffer", "Memcpy"))):
            continue
        rows.append((us / 1e3, evt.count, family(evt.key), evt.key[:120]))
    rows.sort(reverse=True)
    launched = {fam: sum(k * (counted[n] - before[n]) for n, k in names.items())
                for fam, names in OUR_FAMILIES.items()}
    return rows, wall, launched


def profile_by_family(fn, what: str = "one step", out_file: str | None = None,
                      device: torch.device | str = "cuda",
                      tries: int = 3) -> tuple[list, float, float]:
    """Profile fn (profile_once): (families sorted by device time [(family,
    ms, kernel count)], total kernel ms, wall ms) of the recorded step; the
    kernels' rows go to `out_file` where one is given. Each of our kernel families
    must count as many launches as their counters did. The profiler has
    dropped one of our kernels from a window now and then (edge2face's
    streamed frame once listed 4 conv7 launches against the counters' 5, in
    a run where every other window agreed), so a window that disagrees is
    printed ([profile_disagrees]) and recorded anew, up to `tries` windows
    in all; raises if none agrees."""
    for attempt in range(1, tries + 1):
        rows, wall, launched = profile_once(fn, device)
        fams: dict[str, list] = {}
        for ms, n, fam, _ in rows:
            entry = fams.setdefault(fam, [0.0, 0])
            entry[0] += ms
            entry[1] += n
        off = {fam: (fams.get(fam, [0.0, 0])[1], n) for fam, n in launched.items()
               if fams.get(fam, [0.0, 0])[1] != n}
        if not off:
            break
        _say("profile_disagrees", what=repr(what), window=attempt,
             profiler_vs_counters=json.dumps(off),
             rows=json.dumps([(n, key) for _, n, fam, key in rows if fam in off]))
    else:
        raise AssertionError(f"{what}: in {tries} windows the profiler's launches of our "
                             f"kernels never matched the counters: {off}")
    if out_file is not None:
        os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
        with open(out_file, "w") as fh:
            fh.write(f"{what}, wall {wall:.3f} ms, profiler window {attempt}\n")
            for ms, n, fam, key in rows:
                fh.write(f"{ms:10.4f} ms {n:6d}x  {fam:28s} {key}\n")
    table = sorted(((f, v[0], v[1]) for f, v in fams.items()), key=lambda r: -r[1])
    return table, sum(v[0] for v in fams.values()), wall
