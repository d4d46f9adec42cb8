"""The plain reference against vid2vid_tpu_torch at a tiny size on the
CPU, in f32: the same state-dict names, and the same frames over a
sequence from a zero state, with and without several batch elements."""

import pytest
import torch

from portbench import seeding
from portbench.reference.vid2vid import Vid2VidReference
from portbench.streets import street_pool
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator
from vid2vid_tpu_torch.models.inference import InferenceEngine

OPT = dict(label_nc=35, use_instance=True, fg=True, fg_labels=(26,), ngf=16, n_downsample_G=3,
           n_blocks=3, n_blocks_local=1, n_scales_spatial=3, n_frames_G=3, norm="batch",
           isTrain=False)
H, W = 64, 128


def test_the_state_dict_names_are_the_programs():
    with torch.device("meta"):
        ref = Vid2VidReference(OPT)
        gen = Vid2VidGenerator(Options(**OPT))
    assert {k: v.shape for k, v in ref.state_dict().items()} == {
        k: v.shape for k, v in gen.state_dict().items()}


@pytest.mark.parametrize("batch", [1, 2])
def test_the_reference_renders_the_programs_frames(batch):
    with torch.device("meta"):
        ref = Vid2VidReference(OPT)
    state = seeding.seeded_state(ref, 2**31 + 11, "cpu")
    seeding.calibrate_norms(ref, state, 2**31 + 11, H, W, "cpu")
    eng = InferenceEngine(Options(**OPT), device="cpu")
    eng.load_state_dict(state)
    labels, inst = street_pool(5, batch, 8, H, W, 3.0, "cpu")
    s_prog, s_ref = eng.initial_state(batch, H, W), ref.zero_state(batch, H, W, "cpu")
    for t in range(6):
        window = labels[:, t : t + 3], inst[:, t : t + 3]
        frame, s_prog = eng.step(*window, s_prog)
        expect, s_ref = ref.step(*window, s_ref)
        # f32 on both sides; the warps' coordinates differ by the rounding
        # of grid_sample's normalisation
        assert (frame - expect).norm() / expect.norm() < 1e-4
        assert (frame - expect).abs().max() < 1e-3
