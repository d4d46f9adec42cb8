"""A copy of the benchmark with its cells at a tiny size, for CPU tests.

The configuration `tiny` is label2city_2048 at 64 x 128 with ngf 16, 3
blocks and 1 local block. The cell `tiny.stream` runs the stream cell's
mix, is held to its limits and reports every metric it reports;
`tiny.batch4` runs the batch-4 mix kept for a later cell
(traffic/batch4.json, limits/label2city_2048.batch4.json), which drives
the stream driver with B = 4, and reports the same metrics.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = {"label2city_2048.stream": "tiny.stream"}


def tiny_root(root: Path) -> Path:
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    here = root / "portbench"
    cfg = json.loads((here / "configs" / "label2city_2048.json").read_text())
    cfg["height"], cfg["width"] = 64, 128
    cfg["options"].update(ngf=16, n_blocks=3, n_blocks_local=1)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(spec["configs"][0], name="tiny",
                                file="portbench/configs/tiny.json"))
    for w in list(spec["workloads"]):
        spec["workloads"].append(dict(w, name=CELLS[w["name"]], config="tiny"))
        shutil.copy(here / "limits" / f"{w['name']}.json",
                    here / "limits" / f"{CELLS[w['name']]}.json")
    spec["workloads"].append(dict(spec["workloads"][-1], name="tiny.batch4", traffic="batch4"))
    shutil.copy(here / "limits" / "label2city_2048.batch4.json",
                here / "limits" / "tiny.batch4.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [CELLS[w] for w in m["workloads"]] + ["tiny.batch4"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
