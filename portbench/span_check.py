"""The program's spans in a cell's traced window: the check of their
attribution, the readings taken from them (spans.READINGS) beside the
cell's own per-layer metrics, and what the spans cost the host.

    python3 -m portbench.span_check --workload label2city_2048.stream \
        --seed <n> --seconds 10 --out span_check.jsonl

In one process, on the card: the cell's set-up (its driver, as
portbench.run builds it); a window of `--seconds` with no profiler
(Driver.measure); then the traced window of a `--trace 1` run
(Driver.profile, through spans.profile_with_spans). In both, each call of
`InferenceEngine.step` is timed on the host: its enqueue, since the step
before it ended with its frame on the host. One JSON line, printed and
appended to `--out`:

- `enqueue_ms`, `traced_enqueue_ms`: the host's ms a `step` call without
  and under the profiler (median, mean, 95th percentile, count);
- `metrics`: the cell's per-layer metrics, as a `--trace 1` run reads
  them, and the readings of spans.READINGS;
- `attribution`: the device seconds given to spans (and outside them)
  over the window's busy seconds, the share outside the program, the
  operations no launch call in the window matched, and the kernels a
  step by family under the ResnetBlocks' and the 7x7 convs' spans and in
  the whole window;
- `spans`: by span name, ranges, host ms, device ms inclusive and self,
  idle ms inclusive and self, each a step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from portbench.run import ROOT, Run, cache_dirs, card_info, cell_metrics, load_module, read_json
from portbench.spans import CONV7, OUTSIDE, READINGS, RESBLOCK, profile_with_spans

FAMILY_UNDER = {RESBLOCK: "respair (ours)", CONV7: "conv7 (ours)"}


def _ms(host_s: list) -> dict:
    ms = sorted(s * 1e3 for s in host_s)
    return {"median": statistics.median(ms), "mean": statistics.fmean(ms),
            "p95": ms[min(len(ms) - 1, round(0.95 * (len(ms) - 1)))], "n": len(ms)}


def check(root: Path, workload: str, seed: int, seconds: float, device) -> dict:
    """Runs the check on `device`; returns the result line's fields."""
    import torch

    here = root / "portbench"
    spec = read_json(root / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg = read_json(here / "configs" / f"{cell['config']}.json")
    mix = read_json(here / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(here / "drivers" / f"{mix['driver']}.py").Driver(cfg, mix, seed, device)
    host_s, step = [], driver.eng.step

    def timed(*args, **kwargs):
        start = time.perf_counter()
        out = step(*args, **kwargs)
        host_s.append(time.perf_counter() - start)
        return out

    driver.eng.step = timed
    window = driver.measure(seconds)
    untraced = host_s[: len(window.step_s)]
    host_s.clear()
    run = Run(setup_s=0.0, window=window, work=driver.work(), dtype=driver.dtype)
    run.trace, spans = profile_with_spans(driver.profile, mix["profile_steps"])
    traced = host_s[1:]  # the profiler's warm-up step first
    metrics = {m["name"]: load_module(here / "metrics" / f"{m['name']}.py").read(run)
               for m in cell_metrics(spec, workload)[1]}
    metrics.update({name: read(spans, run.work) for name, read in READINGS.items()})
    steps = spans.steps
    attributed = sum(spans.self_s.values())
    names = sorted(spans.count) + [OUTSIDE]

    def per_step(d: dict, n: str):
        return d.get(n, 0.0) * 1e3 / steps

    return {
        "workload": workload, "seed": seed, "torch": torch.__version__,
        "card": card_info() if torch.device(device).type == "cuda" else None,
        "enqueue_ms": _ms(untraced), "traced_enqueue_ms": _ms(traced),
        "metrics": metrics,
        "attribution": {
            "attributed_over_busy": attributed / run.trace.busy_s if run.trace.busy_s else None,
            "outside_share": spans.self_s.get(OUTSIDE, 0.0) / attributed if attributed else None,
            "unlaunched": spans.unlaunched,
            "batch_norm_family_ms": per_step(run.trace.families, "batch norm"),
            "kernels_per_step": {
                n: {"under_span": spans.kernels.get(n, {}).get(f, 0) / steps,
                    "in_window": spans.all_kernels.get(f, 0) / steps, "family": f}
                for n, f in FAMILY_UNDER.items()}},
        "spans": {n: {"ranges": spans.count.get(n, 0) / steps,
                      "host_ms": per_step(spans.host_s, n),
                      "device_ms": per_step(spans.device_s, n),
                      "self_ms": per_step(spans.self_s, n),
                      "idle_ms": per_step(spans.idle_s, n),
                      "idle_self_ms": per_step(spans.idle_self_s, n)} for n in names},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("span_check needs a CUDA device", file=sys.stderr)
        return 2
    result = check(ROOT, args.workload, args.seed, args.seconds, "cuda:0")
    line = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
