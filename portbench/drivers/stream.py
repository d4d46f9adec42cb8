"""The driver of the streaming entry: `InferenceEngine.step` in a closed
loop, one frame of each of B streams a step.

Each stream renders sequences of the mix's `sequence_labels` label maps,
each from a zero state (the start of a sequence without first frames): a
window of tG maps gives one frame, so a sequence gives sequence_labels -
tG + 1 frames. Round g of the loop gives batch element b the pool's
sequence (g * B + b) mod pool_sequences; the label windows stay on the
host, each contiguous (a batch collated at set-up, as a loader would
hand it), and the program moves them to the card.
A step's time runs from handing `step` its window to holding the frame on
the host, copied into one pinned buffer that every step reuses (as a
writer that takes the frames off the card does).

The first `compare_frames` frames of each of the window's first
`compare_rounds` rounds go to pinned host buffers of their own, allotted
at set-up, so that keeping them costs a step nothing: after the window one
round is drawn from the seed among those that gave them all, and the
plain reference renders the same sequences from the same weights, frame
by frame, each batch element compared on its own.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from portbench import compare, seeding, work
from portbench.reference.vid2vid import Vid2VidReference
from portbench.streets import street_pool


@dataclasses.dataclass
class Window:
    """The measured window: each step's seconds, the frames delivered and
    the window's seconds (its start to the last frame's arrival)."""

    step_s: list
    frames: int
    window_s: float


def _pinned(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """A contiguous host copy of x, in pinned memory where `pin`."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=pin).copy_(x)


class Driver:
    """Builds the program and its inputs from the seed, warms up every
    shape the loop uses, then measures, profiles and checks."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        start = time.perf_counter()
        self.setup_phases: dict = {}  # seconds since __init__ began, by phase

        def mark(phase: str) -> None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.setup_phases[phase] = time.perf_counter() - start

        from vid2vid_tpu_torch.config import Options
        from vid2vid_tpu_torch.models.inference import InferenceEngine

        mark("import_program")
        self.cfg, self.seed, self.device = cfg, seed, device
        opt = cfg["options"]
        self.h, self.w, self.batch = cfg["height"], cfg["width"], mix["batch"]
        self.tG, self.k = opt["n_frames_G"], mix["compare_frames"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.frames_per_seq = mix["sequence_labels"] - self.tG + 1
        self.n_seq = mix["pool_sequences"]
        if self.n_seq % self.batch or self.k > self.frames_per_seq:
            raise ValueError("pool_sequences must be a multiple of batch, and "
                             "compare_frames at most a sequence's frames")
        with torch.device("meta"):  # its tensors are the seeded state's (calibrate_norms)
            self.ref = Vid2VidReference(opt)
        self.weights = seeding.seeded_state(self.ref, seed, device)
        mark("weights")
        seeding.calibrate_norms(self.ref, self.weights, seed, self.h, self.w, device)
        mark("norm_statistics")
        labels, inst = street_pool(seed, self.n_seq, mix["sequence_labels"], self.h, self.w,
                                   mix["motion_px"], device)
        # every window the loop hands, contiguous in pinned host memory, as
        # a loader with pin_memory collates a batch (with B = 1 a view of
        # the pool)
        pin = torch.device(device).type == "cuda"
        if self.batch == 1:
            labels, inst = _pinned(labels, pin), _pinned(inst, pin)
        collate = (lambda x: x) if self.batch == 1 else (lambda x: _pinned(x, pin))
        self.windows = [[(collate(labels[s : s + self.batch, t : t + self.tG]),
                          collate(inst[s : s + self.batch, t : t + self.tG]))
                         for t in range(self.frames_per_seq)]
                        for s in range(0, self.n_seq, self.batch)]
        del labels, inst
        # the frame's place on the host, which each step copies into; in
        # the window the first compare_frames frames of the first
        # compare_rounds rounds go to places of their own
        shape = (self.batch, 3, self.h, self.w)
        self.host_frame = torch.empty(shape, pin_memory=pin)
        self.kept = torch.empty((mix["compare_rounds"], self.k) + shape, pin_memory=pin)
        self.keeping = False
        mark("inputs")
        options = Options(**{k: tuple(v) if isinstance(v, list) else v for k, v in opt.items()})
        with torch.device(device):  # PyTorch's init of the weights runs on the card
            self.eng = InferenceEngine(options, device=device)
        self.eng.load_state_dict(self.weights)
        mark("engine")
        self.round, self.t, self.state = -1, self.frames_per_seq, None
        for _ in range(mix["warmup_steps"]):
            self._step()
        mark("warmup")
        self.round, self.t = -1, self.frames_per_seq  # the window starts a round

    def work(self) -> dict:
        """A step's operations and kernel bounds, from the reference on
        `meta` at the cell's shapes."""
        with torch.device("meta"):
            ref = Vid2VidReference(self.cfg["options"])
        shape = (self.batch, self.tG, self.h, self.w)
        labels = torch.zeros(shape, dtype=torch.int64, device="meta")
        state = ref.zero_state(self.batch, self.h, self.w, "meta")
        return work.count_step(ref, lambda: ref.step(labels, labels, state), self.dtype)

    def _window(self, g: int, t: int):
        return self.windows[g % len(self.windows)][t]

    def _step(self) -> float:
        """One step of the loop, its frame copied to the host: its seconds."""
        if self.t == self.frames_per_seq:
            self.round, self.t = self.round + 1, 0
            self.state = self.eng.initial_state(self.batch, self.h, self.w)
        g, t = self.round, self.t
        keep = self.keeping and g < len(self.kept) and t < self.k
        labels, inst = self._window(g, t)
        start = time.perf_counter()
        frame, self.state = self.eng.step(labels, inst, self.state)
        (self.kept[g, t] if keep else self.host_frame).copy_(frame)  # waits for the frame
        seconds = time.perf_counter() - start
        self.t += 1
        return seconds

    def measure(self, seconds: float) -> Window:
        """Steps until `seconds` have passed, keeping the compared frames;
        where round 0 has not given them all by the close, it goes on past
        it, untimed."""
        self.keeping, step_s = True, []
        start = time.perf_counter()
        while True:
            step_s.append(self._step())
            now = time.perf_counter()
            if now - start >= seconds:
                break
        window = Window(step_s=step_s, frames=len(step_s) * self.batch, window_s=now - start)
        self.full_rounds = min(self.round + (self.t >= self.k), len(self.kept))
        while self.full_rounds == 0:
            self._step()
            self.full_rounds = int(self.t >= self.k)
        self.keeping = False
        return window

    def profile(self, steps: int):
        from portbench.trace import profile_steps

        return profile_steps(self._step, steps, self.device)

    def _free_program(self) -> None:
        self.eng = self.state = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, g: int, fp8: bool = False) -> list:
        """The reference's first compare_frames frames of round g, in f32
        with TF32 off (or the float8 control)."""
        self.ref.set_fp8(fp8)
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            state = self.ref.zero_state(self.batch, self.h, self.w, self.device)
            frames = []
            for t in range(self.k):
                labels, inst = self._window(g, t)
                frame, state = self.ref.step(labels.to(self.device), inst.to(self.device),
                                             state)
                frames.append(frame.cpu())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            self.ref.set_fp8(False)
        return frames

    def pick_round(self) -> int:
        """The round the check compares: drawn from the seed among the
        kept rounds whose compare_frames frames the window delivered."""
        return int(np.random.default_rng([self.seed, 1]).integers(self.full_rounds))

    def check(self, limits: dict) -> dict:
        """Frees the program, renders the drawn round with the reference
        and compares: {number: {"value", "limit"}}."""
        g = self.pick_round()
        self._free_program()
        return compare.frames(list(self.kept[g]), self._reference(g), limits)

    def control(self, limits: dict) -> dict:
        """The control in the program's place: the reference in float8
        against the reference, on the same drawn round."""
        g = self.pick_round()
        self._free_program()
        ref = self._reference(g)
        return compare.frames(self._reference(g, fp8=True), ref, limits)
