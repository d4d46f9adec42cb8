"""Readings for the limits of a cell's comparison (limits/<cell>.json).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,.. \
        --control-seeds 7,8,9 --seconds 4 --out readings.jsonl

In one process, on the card: for each program seed, the cell's set-up, a
short window at the cell's own load and its check (the program's
numbers, its lower readings); for each control seed the same set-up and
window, then the control in the program's place: the plain reference in
float8 against the reference in f32, on the same drawn round (the upper
readings). One JSON line a seed, to standard output and to `--out`.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench.run import ROOT, cache_dirs, load_module, read_json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    here = ROOT / "portbench"
    cell = next(w for w in read_json(ROOT / "BENCHMARK.json")["workloads"]
                if w["name"] == args.workload)
    cfg = read_json(here / "configs" / f"{cell['config']}.json")
    mix = read_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(here / "limits" / f"{args.workload}.json")
    driver_cls = load_module(here / "drivers" / f"{mix['driver']}.py").Driver
    jobs = [("program", int(s)) for s in args.seeds.split(",") if s]
    jobs += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    with open(args.out, "a") as out:
        for kind, seed in jobs:
            driver = driver_cls(cfg, mix, seed, "cuda:0")
            driver.measure(args.seconds)
            checks = driver.check(limits) if kind == "program" else driver.control(limits)
            line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                               **{k: v["value"] for k, v in checks.items()}})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
            del driver
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
