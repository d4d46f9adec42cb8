"""BENCHMARK.json against its contract's shape, and a configuration, a
traffic mix and metrics that are only dropped in as files and entries."""

import json
import re
import time
from pathlib import Path

from portbench.run import cell_metrics, run_cell

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_finds_its_files_and_reports_what_it_must():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    here = REPO / "portbench"
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and (here / "metrics" / f"{m['name']}.py").is_file()
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert (here / "drivers" / f"{mix['driver']}.py").is_file()
        assert (here / "limits" / f"{w['name']}.json").is_file()
        e2e, layer = cell_metrics(spec, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        assert all(m["moves"] in names and m["moves"] in e2e_names for m in layer)


STEPS_PER_S = '''def read(run):
    return len(run.window.step_s) / run.window.window_s
'''
FRAME_MS_MAX = '''def read(run):
    return max(run.window.step_s) * 1e3
'''


def test_a_dropped_in_config_mix_and_metrics_run(tiny, tmp_path):
    root = tmp_path / "root"
    (root / "portbench").mkdir(parents=True)
    for path in (tiny / "portbench").rglob("*"):  # a copy: the shared tree stays as it is
        dest = root / path.relative_to(tiny)
        if path.is_dir():
            dest.mkdir(exist_ok=True)
        else:
            dest.write_bytes(path.read_bytes())
    here = root / "portbench"
    cfg = json.loads((here / "configs" / "tiny.json").read_text())
    cfg["options"]["n_scales_spatial"] = 2
    (here / "configs" / "two_scales.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "batch4.json").read_text())
    mix.update(batch=2, pool_sequences=2, sequence_labels=8, compare_frames=3)
    (here / "traffic" / "pairs.json").write_text(json.dumps(mix))
    (here / "limits" / "two_scales.pairs.json").write_text(
        (here / "limits" / "tiny.batch4.json").read_text())
    (here / "metrics" / "steps_per_s.py").write_text(STEPS_PER_S)
    (here / "metrics" / "frame_ms_max.py").write_text(FRAME_MS_MAX)
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="two_scales",
                                file="portbench/configs/two_scales.json"))
    cell = "two_scales.pairs"
    spec["workloads"].append(dict(spec["workloads"][0], name=cell, config="two_scales",
                                  traffic="pairs"))
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    spec["per_layer"].append({"name": "frame_ms_max", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "engine",
                              "moves": "steps_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace, names in ((False, {"setup_s", "steps_per_s"}), (True, {"frame_ms_max"})):
        result = run_cell(root, cell, 2**31 + 3, 0.2, trace, "cpu", start=time.perf_counter())
        assert set(result["metrics"]) == names and result["correct"], result
