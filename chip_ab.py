"""Time the correlation backward, or FlowNetC's training step, of several
checkouts of this repository on one card, in turns, so that two commits
compare on one machine.

Each checkout runs in its own process, through its own chip_smoke.py's
helpers, and builds its own kernels under its own build/ the first time:
  - the backward (default): phase 6's `corr_bwd_case` and `time_ms` (the
    same seeded operands, CUDA events over many calls) at SHAPES;
  - `--flow-train`: phase 9's FlowNetC at batch 8 on 384x512 pairs
    (`flow_pairs`, `seeded_flownet_c`, `timed_steps`), f32 with TF32 off
    and bf16, 5 warm-up and 10 timed steps each, ms a step (host clock);
    then one profiled step (`profile_by_family`): its kernels' device ms
    and the correlation backward's.
Run from the root of a checkout on a machine with one NVIDIA Hopper card,
e.g. with the parent commit unpacked (git archive) under the ignored
build/parent:

    python3 chip_ab.py build/parent . . build/parent
    python3 chip_ab.py --flow-train build/parent . . build/parent

One JSON line per run ({"root", "ms": ...}), then the card's name and
power limit, then one JSON line with every run in order.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# FlowNetC's training shape (batch 8 of 384x512 pairs) and chip_smoke.py's
# CORR_BWD_TIMED
SHAPES = [(8, 256, 48, 64), (2, 256, 64, 128), (2, 256, 32, 64)]

# each runs in the checkout's root, so that its chip_smoke and package import
CHILD_BWD = """
import json, sys
import torch
import chip_smoke as cs
ms = {}
for shape in json.loads(sys.argv[1]):
    args = cs.corr_bwd_case(tuple(shape), torch.Generator().manual_seed(0))
    ms["x".join(map(str, shape))] = cs.time_ms(cs.correlation_bwd, args)
    del args
print(json.dumps(ms))
"""
CHILD_FLOW_TRAIN = """
import json, statistics
import torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
pair, flow = cs.flow_pairs(cs.FLOW_TRAIN_BATCH, *cs.FLOW_TRAIN_HW, seed=0)
ms = {}
for mode, mixed in (("f32", False), ("bf16", True)):
    harness = cs.FlowHarness(cs.seeded_flownet_c(seed=0), mixed_precision=mixed, device=cs.DEV)
    with cs.torch_default_tf32():
        cs.timed_steps(harness, pair, flow, 5)
        steps = cs.timed_steps(harness, pair, flow, 10)
        fams, busy, _ = cs.profile_by_family(lambda: harness.train_step(pair, flow),
                                             f"FlowNetC {mode} step", f"chip_ab_{mode}.txt")
    ms[mode] = statistics.median(steps)
    ms[mode + "_steps"] = [round(v, 3) for v in steps]
    ms[mode + "_kernel_ms"] = busy
    ms[mode + "_correlation_bwd_ms"] = dict((f, t) for f, t, _ in fams).get(
        "correlation backward (ours)", 0.0)
    del harness
    torch.cuda.empty_cache()
print(json.dumps(ms))
"""


def run(root: str, child: str) -> dict:
    out = subprocess.run([sys.executable, "-c", child, json.dumps(SHAPES)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"chip_ab: {root} failed ({out.returncode}):\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(args: list[str]) -> None:
    flow_train = "--flow-train" in args
    roots = [a for a in args if a != "--flow-train"]
    if not roots:
        raise SystemExit(__doc__)
    child = CHILD_FLOW_TRAIN if flow_train else CHILD_BWD
    runs = []
    for root in roots:
        runs.append({"root": root, "ms": run(os.path.abspath(root), child)})
        print(json.dumps(runs[-1]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main(sys.argv[1:])
