"""Streaming inference engine (the test.py path).

Frames are generated one at a time from a rolling window of tG label maps
and the last tG-1 generated frames; the first tG-1 frames come from a
first-frame strategy (zeros or real frames here; the single-image
generator is not ported yet).

Entry points: `step` (one frame from a raw label window and the state —
true streaming) and `generate_clip` (a whole encoded clip). Compute-dtype
policy (--bf16 / --fp16): the engine keeps float32 master weights and
casts a copy of the generator, the inputs and the state to bfloat16 at
entry; the frames it returns are float32, the state stays in the compute
dtype.
"""

from __future__ import annotations

import copy

import torch

from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import ClipOutputs, State, Vid2VidGenerator
from vid2vid_tpu_torch.utils.device import require_device


class InferenceEngine:
    """Inference wrapper around a Vid2VidGenerator on one device: the first
    CUDA device unless the caller passes device='cpu'."""

    def __init__(self, opt: Options, device: torch.device | str = "cuda"):
        if getattr(opt, "n_devices", 1) > 1:
            raise NotImplementedError(
                "--n_devices > 1 (width-sharded serving) is not ported "
                "(ROADMAP.md, queue 1: tools and multi-device)"
            )
        self.opt = opt
        self.device = require_device(device)
        self.compute_dtype = (
            torch.bfloat16 if (opt.bf16 or opt.fp16) else torch.float32
        )
        self.gen = Vid2VidGenerator(opt).to(self.device).eval()
        self._compute_gen: Vid2VidGenerator | None = None

    # ---------------------------------------------------------------- weights

    def load_state_dict(self, state_dict: dict, strict: bool = True):
        """Load master weights (reference names with a G{s}. prefix)."""
        self._compute_gen = None
        return self.gen.load_state_dict(state_dict, strict=strict)

    def compute_generator(self) -> Vid2VidGenerator:
        """The generator in the compute dtype (a cached cast of the master
        weights; `load_state_dict` drops the cache)."""
        if self.compute_dtype == torch.float32:
            return self.gen
        if self._compute_gen is None:
            self._compute_gen = copy.deepcopy(self.gen).to(self.compute_dtype).eval()
        return self._compute_gen

    # ----------------------------------------------------------------- encode

    def encode(self, labels: torch.Tensor, inst: torch.Tensor | None = None):
        return self.gen.encode_input(
            labels.to(self.device), None if inst is None else inst.to(self.device)
        )

    # ------------------------------------------------------------ first frame

    def initial_state(
        self,
        batch: int,
        height: int,
        width: int,
        real_frames: torch.Tensor | None = None,
    ) -> State:
        """Seed state: real frames when given, else zeros.

        real_frames: (B, >= tG-1, 3, H, W); its first tG-1 frames are used.
        """
        if real_frames is not None:
            return self.seed_state(real_frames[:, : self.opt.n_frames_G - 1])
        return self.gen.zero_state(
            batch, height, width, device=self.device, dtype=self.compute_dtype
        )

    @torch.no_grad()
    def seed_state(self, frames: torch.Tensor) -> State:
        """Ring buffers (a pyramid) from (B, tG-1, 3, H, W) frames."""
        return self.gen.state_from_frames(
            frames.to(self.device, self.compute_dtype)
        )

    def build_single_g(self, sg_cfg: dict | None = None):
        raise NotImplementedError(
            "--use_single_G first frames are not ported yet (ROADMAP.md, "
            "queue 1: single-image generators)"
        )

    def face_features(self, *args, **kwargs):
        raise NotImplementedError(
            "the face-feature lookup is not ported yet (ROADMAP.md, queue 1: "
            "single-image generators)"
        )

    # ------------------------------------------------------------------- clip

    @torch.no_grad()
    def generate_clip(
        self, enc_a: torch.Tensor, state: State, use_raw_only: bool = False
    ) -> tuple[ClipOutputs, State]:
        """(B, T+tG-1, C, H, W) encoded labels -> (ClipOutputs in f32, state)."""
        dt = self.compute_dtype
        outs, new_state = self.compute_generator().generate_clip(
            enc_a.to(self.device, dt),
            tuple(s.to(self.device, dt) for s in state),
            use_raw_only=use_raw_only,
        )
        return (
            ClipOutputs(*(None if o is None else o.float() for o in outs)),
            new_state,
        )

    # ------------------------------------------------------------------- step

    @torch.no_grad()
    def step(
        self,
        labels_window: torch.Tensor,
        inst_window: torch.Tensor | None,
        state: State,
        use_raw_only: bool = False,
    ) -> tuple[torch.Tensor, State]:
        """One frame from a raw (B, tG, H, W) label window and the state.

        Returns the (B, 3, H, W) float32 frame and the new state.
        """
        enc = self.encode(labels_window, inst_window)
        outs, new_state = self.generate_clip(enc, state, use_raw_only)
        return outs.fake[:, 0], new_state
