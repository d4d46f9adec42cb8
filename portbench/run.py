"""One run of one benchmark cell of vid2vid_tpu_torch on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the program and its inputs
from the seed, warms up the cell's shapes (set-up: `setup_s`, from the
process's start), measures for `--seconds`, and with `--trace 1` profiles
a short window of steps after it. Then it frees the program, renders the
compared frames with the plain reference and prints one JSON line: the
cell's end-to-end metrics (`--trace 0`) or its per-layer metrics
(`--trace 1`), `correct`, the device, and last the numbers compared,
each beside its limit, which also end standard error.

Everything is found by name: the cell in BENCHMARK.json, its
configuration in configs/<config>.json, its traffic mix in
traffic/<traffic>.json, the mix's driver in drivers/<driver>.py, each
metric's reader in metrics/<metric>.py and the limits of the comparison
in limits/<cell>.json. Adding a cell, a configuration, a mix or a metric
takes new files and entries only.

Caches stay inside the checkout: the program's kernels build under
build/vid2vid_tpu_torch/, and Triton's, torch's extensions' and CUDA's
JIT caches under build/portbench/.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vid2vid_tpu")


def cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout, before torch loads."""
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


@dataclasses.dataclass
class Run:
    """What the metrics' readers read: set-up seconds, the measured window
    (Driver.measure's Window), the traced window (trace.Trace) and a step's
    work (work.count_step) with `--trace 1`, and the compute dtype."""

    setup_s: float
    window: object
    trace: object = None
    work: dict | None = None
    dtype: object = None


def load_module(path: Path):
    """The module of a file found by name (metrics/<name>.py may hold dots)."""
    name = f"portbench_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """The cell's end-to-end metrics (those listing it, or listing no
    cells) and its per-layer metrics (those listing it, or listing no
    cells and moving an end-to-end metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, layer


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device, start: float = PROCESS_START) -> dict:
    """Runs the cell on `device`; returns the result's fields."""
    import torch

    here = root / "portbench"
    spec = read_json(root / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg = read_json(here / "configs" / f"{cell['config']}.json")
    mix = read_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(here / "limits" / f"{workload}.json")
    e2e, layer = cell_metrics(spec, workload)
    driver_start = time.perf_counter() - start
    driver = load_module(here / "drivers" / f"{mix['driver']}.py").Driver(cfg, mix, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    run = Run(setup_s=time.perf_counter() - start, window=None, dtype=driver.dtype)
    run.window = driver.measure(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        run.work = driver.work()
        run.trace = driver.profile(mix["profile_steps"])
    checks = driver.check(limits)
    metrics = {}
    for m in (layer if trace else e2e):
        value = load_module(here / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": None, "attempted": run.window.frames, "failed": 0,
              "metrics": metrics, "device": devinfo}
    if trace:
        from portbench.trace import breakdown

        devinfo.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = breakdown(run.trace)
    result["card"] = card_info() if cuda else None
    print("setup phases (s from the process's start): " + " ".join(
        f"{k}={driver_start + v:.3f}" for k, v in {"import_torch": 0.0,
                                                     **driver.setup_phases}.items()),
          file=sys.stderr)
    from portbench.compare import passed

    result["correct"] = passed(checks)
    result["checks"] = checks
    return result


def card_info() -> dict | None:
    """The card's name and power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    name, limit = out.splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def loaded_forbidden() -> list:
    """The modules of `sys.modules` whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    chips = next((w["chips"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
