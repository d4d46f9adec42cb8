"""The program's spans in a traced window, and what the per-layer readings
of the stream cell's layers take from them.

The program opens its spans with vid2vid_tpu_torch/utils/profiling.py::
`span`: `record_function` ranges named `v2v.*` on the host, on the same
clock as the window's device operations. `reduce_spans` takes the events
of the window that `trace.profile_steps` records and

- gives each device kernel, memcpy and memset (clipped to the window, as
  `trace.reduce_events` clips them) to the innermost program span whose
  host interval holds the CUDA runtime or driver call that launched it,
  the call found by the profiler's correlation id; an operation whose
  call lies in no span, or that no call in the window launched, goes to
  `(outside the program)`;
- gives each span name its device seconds, inclusive (operations under
  any of its ranges) and self (operations whose innermost span it is),
  its host seconds (the union of its ranges) and its count of ranges;
- gives each idle gap of the device (between the union's intervals, as
  `trace.reduce_events` finds them) to the spans open on the host at the
  gap's midpoint: inclusive and, for the innermost, self.

`READINGS` are the per-layer readings of the stream cell from a Spans and
the step's work (`work.count_step`); each gives None where the trace
holds no range of its span, or no device operation where it reads device
time. `trace.profile_steps` discards its events once it has reduced them,
so `profile_with_spans` keeps them through one call of a driver's
`profile`.
"""

from __future__ import annotations

import collections
import dataclasses

from portbench import trace
from portbench.families import family

PREFIX = "v2v."
OUTSIDE = "(outside the program)"
# the program's span names that the readings read (utils/profiling.py's table)
STEP, INPUT = "v2v.engine.step", "v2v.input"
RESBLOCK, CONV7, NORM = "v2v.nn.resblock", "v2v.nn.conv7", "v2v.nn.norm"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver", "cpu_op")  # cpu_op: torch 2.11's events


@dataclasses.dataclass
class Spans:
    """The window's spans: each name's count of ranges and host seconds;
    device seconds inclusive (`device_s`) and self (`self_s`, with
    `(outside the program)`); idle seconds inclusive (`idle_s`) and self
    (`idle_self_s`, with `(outside the program)`); kernels by family
    under each name (inclusive) and in the whole window; the device
    operations whose launch call the window does not hold."""

    steps: int
    count: dict
    host_s: dict
    device_s: dict
    self_s: dict
    idle_s: dict
    idle_self_s: dict
    kernels: dict
    all_kernels: dict
    unlaunched: int


def _open_spans(ranges: list, times: list):
    """For each (t, item) of `times`, in order of t: (item, the names of
    the ranges (start, end, name) open at t, innermost last)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    open_, i = [], 0
    for t, item in sorted(times, key=lambda x: x[0]):
        while i < len(ranges) and ranges[i][0] <= t:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] > t]
        yield item, [r[2] for r in open_]


def _union_s(intervals: list) -> float:
    total, cursor = 0, None
    for a, b in sorted(intervals):
        if cursor is None or a > cursor:
            total, cursor = total + b - a, b
        elif b > cursor:
            total, cursor = total + b - cursor, b
    return total / 1e9


def _gaps(dev: list, t0: int, t1: int) -> list:
    """The window's idle intervals between the device operations' union."""
    gaps, cursor = [], t0
    for a, b in sorted((d[0], d[1]) for d in dev):
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        gaps.append((cursor, t1))
    return gaps


def reduce_spans(events, steps: int) -> Spans:
    """The Spans of the profiler's events (kineto_results.events()) of a
    window of `steps` steps."""
    window = [e for e in events
              if e.name() == trace.WINDOW and trace._kind(e) == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{trace.WINDOW}' ranges, not one")
    t0, t1 = window[0].start_ns(), window[0].start_ns() + window[0].duration_ns()
    ranges, dev, launch_at = [], [], {}
    for e in events:
        kind = trace._kind(e)
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind in trace.DEVICE_KINDS and b > t0 and a < t1:
            dev.append((max(a, t0), min(b, t1), kind, e.name(), e.correlation_id()))
        elif kind == "user_annotation" and e.name().startswith(PREFIX) and t0 <= a < t1:
            ranges.append((a, b, e.name()))
        elif kind in LAUNCH_KINDS and e.name().startswith("cu"):
            launch_at[e.correlation_id()] = a
    device_s, self_s = collections.Counter(), collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    all_kernels: collections.Counter = collections.Counter()
    launched = [(launch_at[d[4]], d) for d in dev if d[4] in launch_at]
    unlaunched = [(d, []) for d in dev if d[4] not in launch_at]
    for (a, b, kind, name, _), names in [*_open_spans(ranges, launched), *unlaunched]:
        self_s[names[-1] if names else OUTSIDE] += (b - a) / 1e9
        for n in set(names):
            device_s[n] += (b - a) / 1e9
            if kind == "kernel":
                kernels[n][family(name)] += 1
        if kind == "kernel":
            all_kernels[family(name)] += 1
    idle_s, idle_self_s = collections.Counter(), collections.Counter()
    gaps = [((a + b) // 2, (a, b)) for a, b in _gaps(dev, t0, t1)]
    for (a, b), names in _open_spans(ranges, gaps):
        idle_self_s[names[-1] if names else OUTSIDE] += (b - a) / 1e9
        for n in set(names):
            idle_s[n] += (b - a) / 1e9
    by_name = collections.defaultdict(list)
    for a, b, name in ranges:
        by_name[name].append((a, b))
    return Spans(steps=steps, count={n: len(r) for n, r in by_name.items()},
                 host_s={n: _union_s(r) for n, r in by_name.items()},
                 device_s=dict(device_s), self_s=dict(self_s), idle_s=dict(idle_s),
                 idle_self_s=dict(idle_self_s),
                 kernels={n: dict(c) for n, c in kernels.items()},
                 all_kernels=dict(all_kernels), unlaunched=len(unlaunched))


def profile_with_spans(profile, steps: int) -> tuple:
    """(trace.Trace, Spans) of one traced window: `profile(steps)` (a
    driver's, which calls trace.profile_steps) with `trace.reduce_events`
    wrapped for the call, so that the window's events are kept for
    `reduce_spans` too."""
    kept, reduce_events = [], trace.reduce_events

    def keep(events, n):
        kept.append(events)
        return reduce_events(events, n)

    trace.reduce_events = keep
    try:
        reduced = profile(steps)
    finally:
        trace.reduce_events = reduce_events
    return reduced, reduce_spans(kept[0], steps)


def _per_step_ms(seconds: dict, name: str, spans: Spans):
    if name not in spans.count or not spans.all_kernels:  # no span, or no device
        return None
    return seconds.get(name, 0.0) * 1e3 / spans.steps


def _roofline(bound_s: float, name: str, spans: Spans):
    device_s = spans.device_s.get(name)
    if not device_s:
        return None
    return 100.0 * bound_s * spans.steps / device_s


READINGS = {
    # the host's dispatch time of a step: the mean host range of the step
    "host_ms_per_step.serve": lambda s, work: (
        s.host_s[STEP] * 1e3 / s.count[STEP] if STEP in s.count else None),
    # the device's idle ms a step while the host is inside the step
    "step_idle_ms.serve": lambda s, work: _per_step_ms(s.idle_s, STEP, s),
    # the input's upload, one-hot, instance edges, cast and pyramid
    "input_ms_per_step.serve": lambda s, work: _per_step_ms(s.device_s, INPUT, s),
    # the eval batch norms outside the ResnetBlocks
    "norm_ms_per_step.serve": lambda s, work: _per_step_ms(s.device_s, NORM, s),
    # the step's operations under none of its layers' spans
    "glue_ms_per_step.serve": lambda s, work: _per_step_ms(s.self_s, STEP, s),
    # the eval ResnetBlocks' bound over their spans' device time
    "resblock_roofline": lambda s, work: _roofline(work["respair"], RESBLOCK, s),
    # the reflect-padded 7x7 convs' bound over their spans' device time
    "conv7_layer_roofline": lambda s, work: _roofline(work["conv7"], CONV7, s),
}
