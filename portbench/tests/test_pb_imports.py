"""Nothing the benchmark loads is JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "vid2vid_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "torch", "math"}, path


RUN = """
import sys, time
from pathlib import Path
from portbench.run import run_cell, loaded_forbidden
run_cell(Path(sys.argv[1]), "tiny.stream", 7, 0.1, False, "cpu", start=time.perf_counter())
print(",".join(loaded_forbidden()))
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""
REFERENCE = """
import sys, torch
from portbench.reference.vid2vid import Vid2VidReference
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str, *args) -> list:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return [line.split(",") for line in out.rstrip("\n").split("\n")]


def test_a_cpu_run_of_the_harness_loads_no_jax(tiny):
    forbidden, loaded = _modules(RUN, str(tiny))
    assert forbidden == [""] and not set(loaded) & FORBIDDEN
    assert "vid2vid_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    (loaded,) = _modules(REFERENCE)
    assert not set(loaded) & (FORBIDDEN | {"vid2vid_tpu_torch", "portbench_drivers_stream"})
