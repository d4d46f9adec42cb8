"""Two sets of runs of one cell on the same seeds, for its bounds.

    python3 -m portbench.sets --workload <cell> --seconds 20 --out sets.jsonl \
        --seeds 11,12,13,14,15,16 --traced 17,18,19

On the card, each run its own process (`python3 -m portbench.run`): one
run on the first seed that builds (its set-up is the first run's, kept
apart; it is in no set), set A over `--seeds`, set B over the same seeds,
then one `--trace 1` run a seed of `--traced`. One JSON line a run to
`--out` (its kind, seed, exit code, seconds and result line). Then, for each end-to-end metric, each set's
median and spread (first to third quartile by `statistics.quantiles`,
over the median), the spread without the run farthest from the median,
and five times the widest spread. Exits 1 where a run failed or read not
correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)], capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    if result is None:
        print(proc.stderr[-2000:], file=sys.stderr)
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - start, "result": result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--traced", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [("build", seeds[0], 0)] + [("A", s, 0) for s in seeds]
    jobs += [("B", s, 0) for s in seeds]
    jobs += [("traced", int(s), 1) for s in args.traced.split(",") if s]
    runs, ok = [], True
    with open(args.out, "a") as out:
        for kind, seed, trace in jobs:
            r = {"workload": args.workload, "kind": kind, **run(args.workload, seed,
                                                                args.seconds, trace)}
            res = r["result"]
            ok &= res is not None and res["correct"] is True
            out.write(json.dumps(r) + "\n")
            out.flush()
            checks = res and {k: v["value"] for k, v in res["checks"].items()}
            print(f"{kind} seed={seed} trace={trace} rc={r['rc']} wall={r['wall_s']:.1f} "
                  f"correct={res and res['correct']} checks={checks}", flush=True)
            runs.append(r)
    by_set = {k: [r["result"]["metrics"] for r in runs if r["kind"] == k and r["result"]]
              for k in ("A", "B")}
    for name in sorted(by_set["A"][0] if by_set["A"] else []):
        sets = {k: [m[name]["value"] for m in v if name in m] for k, v in by_set.items()}
        if min(len(v) for v in sets.values()) < 3:
            continue
        line = {k: {"median": statistics.median(v), "spread": spread(v),
                    "trimmed_spread": spread(trimmed(v))} for k, v in sets.items()}
        widest = max(s["spread"] for s in line.values())
        print(json.dumps({"metric": name, **line, "five_times_widest": 5 * widest}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
