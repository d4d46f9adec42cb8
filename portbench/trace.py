"""A short profiled window of steps, reduced to what the per-layer metrics
and the result's `breakdown` read.

Two habits of torch.profiler on the H100, which `open_window` /
`close_window` work around (copied from the program's
utils/profiling.py): without a warm-up step it loses the first kernels of
a window, and a window whose first kernel comes from a library launched
through ctypes loses that kernel; a PyTorch fill at both ends, outside the
measured range, keeps every kernel of the steps inside it.

The measured range is the user annotation "portbench.window" around the
steps and the synchronize that ends them, on the trace's one clock, which
the host's and the device's events share.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time

import torch

from portbench.families import family

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def open_window(device) -> None:
    """One PyTorch kernel (a fill), then a synchronize."""
    torch.zeros(1, device=device)
    sync(device)


def close_window(device) -> None:
    """The same fill, then 2 ms of host time, so that no kernel of the
    window ends near the profiler's end."""
    open_window(device)
    time.sleep(0.002)


@dataclasses.dataclass
class Trace:
    """The reduced window: its length and the device's busy time in
    seconds (busy: the union of kernel, memcpy and memset intervals), the
    steps in it, the kernels launched, device seconds by kernel family,
    and idle seconds by the host operation running at each gap."""

    window_s: float
    busy_s: float
    steps: int
    kernels: int  # 0 in a trace without the device's activity
    families: dict
    idle_by_host_op: dict


def _kind(e) -> str:
    """The event's activity type; where the profiler's events do not give
    it (torch 2.11), worked out from the device, the user-annotation flag
    and the name. Host events are then all "cpu_op", the CUDA runtime's
    calls among them."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


def reduce_events(events, steps: int) -> Trace:
    """A Trace from the profiler's events (kineto_results.events()) of a
    window of `steps` steps."""
    span = [e for e in events if e.name() == WINDOW and _kind(e) == "user_annotation"]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} '{WINDOW}' ranges, not one")
    t0, t1 = span[0].start_ns(), span[0].start_ns() + span[0].duration_ns()
    dev, host = [], []
    for e in events:
        kind = _kind(e)
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind in DEVICE_KINDS and b > t0 and a < t1:
            dev.append((max(a, t0), min(b, t1), kind, e.name()))
        elif kind in ("cpu_op", "cuda_runtime"):
            host.append((a, b, e.name()))
    fams: collections.Counter = collections.Counter()
    for a, b, kind, name in dev:
        fams[family(name) if kind != "gpu_memcpy" else "memcpy"] += (b - a) / 1e9
    busy, gaps, cursor = 0, [], t0
    for a, b, _, _ in sorted(dev):
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < t1:
        gaps.append((cursor, t1))
    # the innermost host operation at each gap's midpoint: of the operations
    # begun by then and not yet ended, the one begun last (they nest)
    idle: collections.Counter = collections.Counter()
    host.sort()
    begun, i = [], 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(begun, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while begun and begun[0][1] <= mid:
            heapq.heappop(begun)
        idle[begun[0][2] if begun else "(host between operators)"] += (b - a) / 1e9
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9, steps=steps,
                 kernels=sum(1 for d in dev if d[2] == "kernel"),
                 families=dict(fams), idle_by_host_op=dict(idle))


def profile_steps(step, steps: int, device) -> Trace:
    """Profile `steps` calls of `step()` after one warm-up call inside the
    profiler, and reduce the window."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    recorded = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: recorded.append(p.profiler.kineto_results.events())
                 ) as prof:
        step()
        sync(device)
        prof.step()
        open_window(device)
        with record_function(WINDOW):
            for _ in range(steps):
                step()
            sync(device)
        close_window(device)
        prof.step()
    return reduce_events(recorded[0], steps)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result's `breakdown`: device seconds by family and idle seconds
    by host operation in the traced window, the largest first."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(trace.families), "idle_gaps": largest(trace.idle_by_host_op)}
