"""Train-side time ledger of the 512x256 training recipe (the port of
vid2vid_tpu/tools/train_ledger.py).

Where a training iteration's time goes, step by step: the steady rate of
`Trainer.train_clip`, then a serialized split in which every call of the G
step, the D step, the D_T steps and the reference flow (FlowNet2 forward)
is bracketed by `torch.cuda.synchronize` and timed; the rest of an
iteration's wall time is the host's bookkeeping. Serializing removes the
overlap of host and device work, so the split's total is at least the
steady time; the difference is that overlap. A `sync floor` row is the
time of one empty synchronized call, which every serialized row pays once.

Each step's FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over
the calls of one counted clip, summed by the dtype of each counted
operator's first operand. Its bound is those FLOPs over the card's peak
for their dtype (bf16: the tensor cores, dense; float32: the CUDA cores,
TF32 being off in the steps, as PERF.md counts), and `frac_of_bound` is
the bound over the measured time; `mfu_pct` is all the row's FLOPs over its
time at the bf16 dense peak, the card's headline rate. FlopCounterMode sees PyTorch's operators
only, not the port's kernels launched through ctypes: the correlation of
FlowNetC is counted here from `ops/correlation.py::correlation_taps` (one
FMA a tap inside the image, two FLOPs); the warps (forward and backward;
O(10) FLOPs a pixel, under 0.1% of any row) are not counted.

Config: `RECIPE`, bench.py::bench_train's (the train_512 recipe,
reference scripts/street/train_512.sh + train.py:40-76): 512x256, batch 1,
tG 3, chunks of 2 frames, instance maps, fg, G + D + 2 D_T, VGG, bf16 G
with remat, FlowNet2 in f32 with seeded weights for the reference flow
(the reference pays this forward on every chunk, train.py:60), on an
8-frame synthetic clip (3 chunks).

    python -m vid2vid_tpu_torch.tools.train_ledger [--reps 4] [--no-remat]
    python -m vid2vid_tpu_torch.tools.train_ledger --device cpu   # TINY, a test

It prints the table and one JSON line ("JSON: {...}") with a row per step
(ms_per_iter, calls_per_iter, tflop_per_iter, bound_ms, mfu_pct,
frac_of_bound, launches_per_iter of the port's kernels). On the CPU the
device numbers (bound, MFU, share of bound) are null: there is no card to
measure.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data.synthetic import moving_square_clip
from vid2vid_tpu_torch.models.flownet2.nets import init_flownet_weights
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator
from vid2vid_tpu_torch.ops.correlation import correlation_taps
from vid2vid_tpu_torch.ops.resize import make_divisible
from vid2vid_tpu_torch.train import loop
from vid2vid_tpu_torch.utils.device import require_device
from vid2vid_tpu_torch.utils.profiling import read_launches

# the 512x256 label2city training recipe at full width (bench.py's
# bench_train; recipes/street/train_512.sh on one card: loadSize 512,
# n_frames_total 6, max_frames_per_gpu 2, with bf16 and remat)
RECIPE = dict(
    label_nc=35, use_instance=True, fg=True, fg_labels=(26,), ngf=128,
    n_downsample_G=3, n_blocks=9, n_scales_spatial=1, n_frames_G=3,
    n_frames_D=3, n_scales_temporal=2, n_frames_total=6, max_frames_per_gpu=2,
    norm="batch", bf16=True, remat=True, isTrain=True, fineSize=512,
)
RECIPE_HW, RECIPE_FRAMES = (256, 512), 8
# the same steps at a size the CPU runs in seconds (f32, no VGG; its flow,
# FlowNet2, keeps its widths): for tests of the ledger, not a measurement
TINY = dict(RECIPE, label_nc=4, fg_labels=(3,), ngf=8, n_downsample_G=2, n_blocks=2,
            ndf=8, num_D=1, n_layers_D=2, no_vgg=True, bf16=False, fineSize=64)
TINY_HW, TINY_FRAMES = (64, 64), 6
# dense peak FLOP/s by card (NVIDIA's data sheets): (bf16 on the tensor
# cores, float32 on the CUDA cores); the first name fragment found in
# torch.cuda.get_device_name wins
PEAKS = [("H100 PCIe", 756e12, 51e12), ("H100 NVL", 835e12, 60e12),
         ("H100", 989e12, 67e12), ("H200", 989e12, 67e12)]
STEPS = ("g_step", "d_step", "dt_step")
FLOW_ROW = "flownet2_fwd"


def peaks(device: torch.device) -> dict | None:
    """{dtype: peak FLOP/s} of the card, or None (the CPU, or a card
    without an entry in PEAKS)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for fragment, bf16, f32 in PEAKS:
        if fragment in name:
            return {torch.bfloat16: bf16, torch.float16: bf16, torch.float32: f32}
    return None


class FlopsByDtype(FlopCounterMode):
    """FlopCounterMode that also sums each counted operator's FLOPs by the
    dtype of its first tensor operand (`by_dtype`)."""

    def __init__(self):
        super().__init__(display=False)
        self.by_dtype: collections.Counter = collections.Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            dtype = next((a.dtype for a in args if torch.is_tensor(a)), None)
            self.by_dtype[dtype] += self.flop_registry[func_packet](*args, **kwargs,
                                                                     out_val=out)
        return super()._count_flops(func_packet, out, args, kwargs)


def correlation_flops(frames: torch.Tensor) -> int:
    """FLOPs of the one FlowNetC correlation in a FlowEstimator call on
    (..., 3, H, W) frame pairs: 256-channel features at 1/8 of the frames
    resized to multiples of 64, two FLOPs a tap inside the image
    (correlation_taps)."""
    pairs = int(np.prod(frames.shape[:-3]))
    h, w = (make_divisible(n, 64) // 8 for n in frames.shape[-2:])
    return 2 * pairs * 256 * correlation_taps(h, w)


class Ledger:
    """The timed and counted calls of each row."""

    def __init__(self, device: torch.device):
        self.device = device
        self.counting = False  # FLOPs counted on every call while True
        self.ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.launches = collections.defaultdict(collections.Counter)
        self.flops = collections.defaultdict(collections.Counter)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn, extra_flops=None):
        """fn, timed between two synchronizations, its launches of the
        port's kernels counted, and under `counting` its FLOPs."""
        def timed(*args, **kwargs):
            counter = FlopsByDtype() if self.counting else contextlib.nullcontext()
            self.sync()
            before = read_launches()
            t0 = time.perf_counter()
            with counter:
                out = fn(*args, **kwargs)
            self.sync()
            if self.counting:
                self.flops[name].update(counter.by_dtype)
                if extra_flops is not None:
                    self.flops[name][torch.float32] += extra_flops(*args)
            else:
                self.ms[name] += (time.perf_counter() - t0) * 1e3
                self.calls[name] += 1
                after = read_launches()
                self.launches[name].update({k: after[k] - before[k] for k in after
                                            if after[k] != before[k]})
            return out
        return timed

    @contextlib.contextmanager
    def installed(self, trainer: loop.Trainer):
        """The trainer's steps (which train/loop.py imported by name) and
        its flow_fn wrapped for the block, and put back after."""
        saved = {name: getattr(loop, name) for name in STEPS}
        flow_fn = trainer.flow_fn
        for name in STEPS:
            setattr(loop, name, self.wrap(name, saved[name]))
        trainer.flow_fn = self.wrap(FLOW_ROW, flow_fn, lambda cur, prev: correlation_flops(cur))
        try:
            yield
        finally:
            for name in STEPS:
                setattr(loop, name, saved[name])
            trainer.flow_fn = flow_fn


def sync_floor_ms(device: torch.device, n: int = 10) -> float:
    """Median ms of one empty synchronized call (a one-element add)."""
    z = torch.zeros(1, device=device)
    times = []
    for _ in range(n + 1):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        z = z + 1.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def build_trainer(device: torch.device, remat: bool):
    """(Trainer with seeded weights, its state, labels, frames) of the
    recipe on the card, or of TINY on the CPU."""
    cfg, (h, w), n_frames = ((RECIPE, RECIPE_HW, RECIPE_FRAMES) if device.type == "cuda"
                             else (TINY, TINY_HW, TINY_FRAMES))
    opt = Options(**dict(cfg, remat=remat))
    est = FlowEstimator()
    init_flownet_weights(est, torch.Generator().manual_seed(1))
    trainer = loop.Trainer(opt, flow_fn=est.to(device).eval(), device=device)
    state = trainer.init_state()
    labels, frames = moving_square_clip(np.random.default_rng(0), n_frames, h, w,
                                        opt.label_nc)
    return trainer, state, torch.from_numpy(labels).to(device), torch.from_numpy(frames).to(device)


def run(device: torch.device | str = "cuda", reps: int = 4, remat: bool = True) -> dict:
    """The ledger as a dict: one entry per row, and the totals."""
    device = require_device(device)
    floor = sync_floor_ms(device)
    trainer, state, labels, frames = build_trainer(device, remat)
    ledger = Ledger(device)
    trainer.train_clip(state, labels, frames, labels)  # warm-up

    ledger.sync()
    t0 = time.perf_counter()
    for _ in range(2):
        trainer.train_clip(state, labels, frames, labels)
    ledger.sync()
    steady_s = time.perf_counter() - t0

    with ledger.installed(trainer):
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.train_clip(state, labels, frames, labels)
        total_ms = (time.perf_counter() - t0) * 1e3
        ledger.counting = True
        trainer.train_clip(state, labels, frames, labels)
    n_chunks = ledger.calls["g_step"] // reps  # one G step a chunk
    iters = reps * n_chunks
    steady_it_s = 2 * n_chunks / steady_s
    peak = peaks(device)
    out = {}
    for name in (*STEPS, FLOW_ROW):
        ms = ledger.ms[name] / iters
        flops = {dt: n / n_chunks for dt, n in ledger.flops[name].items()}
        total = sum(flops.values())
        row = {
            "ms_per_iter": ms, "calls_per_iter": ledger.calls[name] / iters,
            "tflop_per_iter": total / 1e12,
            "tflop_by_dtype": {str(dt).removeprefix("torch."): n / 1e12
                               for dt, n in flops.items()},
            "launches_per_iter": {k: v / iters for k, v in ledger.launches[name].items()},
            "bound_ms": None, "mfu_pct": None, "frac_of_bound": None,
        }
        if peak is not None:
            bound = sum(n / peak.get(dt, peak[torch.float32]) for dt, n in flops.items()) * 1e3
            row.update(bound_ms=bound, frac_of_bound=bound / ms,
                       mfu_pct=100 * total / peak[torch.bfloat16] / (ms / 1e3))
        out[name] = row
    serialized = total_ms / iters
    out["host+bookkeep"] = {"ms_per_iter": serialized - sum(out[n]["ms_per_iter"]
                                                            for n in (*STEPS, FLOW_ROW))}
    out["sync floor"] = {"ms_per_iter": floor}
    out.update(steady_it_s=steady_it_s, steady_ms_per_iter=1e3 / steady_it_s,
               serialized_ms_per_iter=serialized, iters=iters, remat=remat,
               device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               config="RECIPE 512x256" if device.type == "cuda" else "TINY 64x64")
    return out


def _num(v, fmt: str) -> str:
    return "-" if v is None else format(v, fmt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=4, help="timed clips of the serialized split")
    ap.add_argument("--no-remat", action="store_true", help="the G step without remat")
    args = ap.parse_args(argv)
    ledger = run(args.device, args.reps, not args.no_remat)
    print(f"== train ledger: {ledger['config']} on {ledger['device']}, "
          f"{ledger['iters']} iters, remat {ledger['remat']} ==")
    print(f"steady rate: {ledger['steady_it_s']:.3f} it/s "
          f"({ledger['steady_ms_per_iter']:.2f} ms/iter)")
    print(f"serialized total: {ledger['serialized_ms_per_iter']:.2f} ms/iter (overlap hidden "
          f"by the steady run: "
          f"{ledger['serialized_ms_per_iter'] - ledger['steady_ms_per_iter']:+.2f} ms)")
    print(f"{'step':<14}{'ms/iter':>9}{'calls':>7}{'TFLOP':>9}{'bound ms':>10}{'MFU%':>7}"
          f"{'of-bound':>9}")
    for name in (*STEPS, FLOW_ROW):
        r = ledger[name]
        print(f"{name:<14}{r['ms_per_iter']:>9.2f}{r['calls_per_iter']:>7.2f}"
              f"{r['tflop_per_iter']:>9.4f}{_num(r['bound_ms'], '.2f'):>10}"
              f"{_num(r['mfu_pct'], '.2f'):>7}{_num(r['frac_of_bound'], '.3f'):>9}")
    for name in ("host+bookkeep", "sync floor"):
        print(f"{name:<14}{ledger[name]['ms_per_iter']:>9.2f}")
    print("JSON:", json.dumps(ledger))
    return ledger


if __name__ == "__main__":
    main()
