"""Per-call cost of the width-sharded serving step (the port of
vid2vid_tpu/tools/shard_serve_bench.py).

Three variants, each the median over --reps calls of InferenceEngine.step
on one 256x512 label2city window (label_nc 35 with instance maps, ngf 32,
2 downsamples, 4 blocks, one scale; --flagship: the flagship at 2048x1024,
bf16; --width W: frames W wide in its place, any multiple of N, whose
coarser levels split unevenly where they must), each call read back before
the next:

  A. the one-device engine in this process, inputs from the host;
  B. the N-rank engine (--n_devices N, the model axis: data 1 x model N),
     inputs from the host on every call;
  C. the N-rank engine, inputs placed on each rank's device before the
     timed calls.

B - C prices moving the window to the device a call; C - A prices the
sharded step's halo exchanges and gathers. Ranks that share cores or a
card (gloo ranks on the CPU; `--ranks_per_card` ranks on one card, over
gloo, since NCCL refuses two ranks on one device) measure correctness and
host overhead, not scaling. It asserts that the sharded frame equals the
single one (mean abs difference below 1e-4, as the JAX tool does; the max
is printed too) and exits non-zero otherwise.

Run:  python -m vid2vid_tpu_torch.tools.shard_serve_bench [--n_devices 2]
      [--reps 30] [--device cpu|cuda] [--ranks_per_card N] [--flagship]
      [--width W]
On the CPU the ranks are gloo processes; on cards, rank r on cuda:r over
NCCL, or with --ranks_per_card N > 1 every rank on cuda:0 over gloo.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.inference import InferenceEngine
from vid2vid_tpu_torch.nn.layers import init_weights
from vid2vid_tpu_torch.parallel.mesh import launch

TG = 3
# the JAX tool's configuration
SMALL = dict(label_nc=35, use_instance=True, output_nc=3, ngf=32, n_downsample_G=2,
             n_blocks=4, n_scales_spatial=1, n_frames_G=TG, norm="batch", fg=False,
             fg_labels=(), isTrain=False, bf16=False)
SMALL_HW = (256, 512)
# the flagship (bench.py's label2city 2048x1024)
FLAGSHIP = dict(label_nc=35, use_instance=True, output_nc=3, ngf=128, n_downsample_G=3,
                n_blocks=9, n_blocks_local=3, n_scales_spatial=3, n_frames_G=TG,
                norm="batch", fg=True, fg_labels=(26,), isTrain=False, bf16=True)
FLAGSHIP_HW = (1024, 2048)
SEED = 0


def config(flagship: bool, width: int | None = None) -> tuple[dict, tuple[int, int]]:
    """(Options keywords, (H, W)) of the benched configuration, W = width
    if given."""
    kw, (h, w) = (FLAGSHIP, FLAGSHIP_HW) if flagship else (SMALL, SMALL_HW)
    return kw, (h, width or w)


def window(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """The timed (1, tG, H, W) label and instance window (numpy seed 0)."""
    rng = np.random.default_rng(SEED)
    return (rng.integers(0, 35, (1, TG, h, w)).astype(np.int32),
            rng.integers(0, 8, (1, TG, h, w)).astype(np.int32))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_engine(opt: Options, hw: tuple[int, int], device: str, reps: int,
                 preplace: bool) -> tuple[float, torch.Tensor]:
    """(median ms a call of eng.step, the frame on the CPU) for this
    process's engine: one device, or this rank's of a launched group (only
    rank 0's weights are seeded here: the engine broadcasts them)."""
    eng = InferenceEngine(opt, device=device)
    if eng.mesh is None or eng.mesh.rank == 0:
        init_weights(eng.gen, torch.Generator().manual_seed(SEED))
    lab_np, inst_np = window(*hw)
    state = eng.initial_state(1, *hw)

    def inputs():
        lab, inst = torch.from_numpy(lab_np), torch.from_numpy(inst_np)
        if preplace:
            lab, inst = lab.to(eng.device), inst.to(eng.device)
            _sync(eng.device)
        return lab, inst

    lab, inst = inputs()
    frame, _ = eng.step(lab, inst, state)  # warm-up: caches, the kernels' first launch
    float(frame[0, 0, 0, 0])
    ts = []
    for _ in range(reps):
        if not preplace:
            lab, inst = inputs()
        t0 = time.perf_counter()
        frame, _ = eng.step(lab, inst, state)
        float(frame[0, 0, 0, 0])  # the readback barrier
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), frame.cpu()


def bench_rank(opt: Options, hw: tuple[int, int], on_card: bool, reps: int) -> dict:
    """A launched rank (on the card launch made current, or the CPU):
    variants B and C."""
    device = f"cuda:{torch.cuda.current_device()}" if on_card else "cpu"
    b_ms, frame = bench_engine(opt, hw, device, reps, preplace=False)
    c_ms, _ = bench_engine(opt, hw, device, reps, preplace=True)
    return {"B": b_ms, "C": c_ms, "frame": frame}


def run(n_devices: int = 2, reps: int = 30, device: str = "cpu", ranks_per_card: int = 1,
        flagship: bool = False, width: int | None = None) -> dict:
    """A, B and C in ms a call, the sharded-vs-single frame differences,
    and the configuration (frames `width` wide if given). The ranks: gloo
    on the CPU; on cards rank r on cuda:r over NCCL, or with ranks_per_card
    > 1 all on cuda:0 over gloo."""
    kw, hw = config(flagship, width)
    a_ms, single = bench_engine(Options(**kw), hw, device, reps, preplace=False)
    on_card = device != "cpu"
    if not on_card:
        devices, backend = ["cpu"] * n_devices, "gloo"
    elif ranks_per_card > 1:
        devices, backend = ["cuda:0"] * n_devices, "gloo"
    else:
        devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
    # CPU ranks share the cores: each takes its share of intra-op threads
    threads = None if on_card else max(1, torch.get_num_threads() // n_devices)
    ranks = launch(bench_rank, n_devices, args=(Options(**kw, n_devices=n_devices), hw,
                                                on_card, reps),
                   devices=devices, backend=backend, threads=threads)
    diff = (ranks[0]["frame"] - single).abs()
    return {"A_ms": a_ms, "B_ms": ranks[0]["B"], "C_ms": ranks[0]["C"],
            "B_ms_ranks": [r["B"] for r in ranks], "C_ms_ranks": [r["C"] for r in ranks],
            "mean_abs_delta": float(diff.mean()), "max_abs_delta": float(diff.max()),
            "ranks_equal": all(torch.equal(r["frame"], ranks[0]["frame"]) for r in ranks),
            "config": (f"flagship {hw[1]}x{hw[0]} bf16" if flagship else
                       "label_nc 35 + instance, ngf 32, 2 downsamples, 4 blocks, 1 scale, "
                       f"{hw[0]}x{hw[1]} f32"),
            "n_devices": n_devices, "device": device, "backend": backend, "reps": reps}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_devices", type=int, default=2)
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    p.add_argument("--ranks_per_card", type=int, default=1)
    p.add_argument("--flagship", action="store_true")
    p.add_argument("--width", type=int, default=None,
                   help="frames this wide (a multiple of --n_devices)")
    a = p.parse_args(argv)
    out = run(a.n_devices, a.reps, a.device, a.ranks_per_card, a.flagship, a.width)
    n = a.n_devices
    print(f"config: {out['config']}; {n} ranks on {a.device} over {out['backend']}")
    print(f"A single device, host input    : {out['A_ms']:8.2f} ms/call")
    print(f"B {n} ranks, host input          : {out['B_ms']:8.2f} ms/call")
    print(f"C {n} ranks, pre-placed input    : {out['C_ms']:8.2f} ms/call")
    print(f"per-call input placement (B-C) : {out['B_ms'] - out['C_ms']:8.2f} ms")
    print(f"sharded vs single (C-A)        : {out['C_ms'] - out['A_ms']:8.2f} ms")
    print(f"sharded-vs-single frame: mean abs {out['mean_abs_delta']:.2e}, "
          f"max abs {out['max_abs_delta']:.2e}; ranks equal: {out['ranks_equal']}")
    print(json.dumps({k: v for k, v in out.items()}))
    if out["mean_abs_delta"] >= 1e-4 or not out["ranks_equal"]:
        raise SystemExit("the sharded step must match the single-device step")
    print("OK")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
