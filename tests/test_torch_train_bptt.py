"""Truncated BPTT over three frames, remat, and the full training recipe's
structure, on the CPU.

Two chunks of the port's Trainer against the JAX package's at
n_frames_bp 3 (the gradient runs through the previous frames of the chunk),
with tests/test_train_oracle.py's bounds; remat on and off give the same
losses, grad norms and updated weights in the port; and the structure of
the 512x256 training recipe (instance edges, fg, two temporal scales, bf16
generator, remat) trains whole clips at a tiny width.
"""

import numpy as np
import pytest
import torch

from torch_parity import losses_within, run_jax, run_port
from vid2vid_tpu_torch.config import Options
from vid2vid_tpu_torch.data.synthetic import moving_square_clip
from vid2vid_tpu_torch.train.loop import Trainer, refresh_batch_stats

N_FRAMES_BP = 3


@pytest.fixture(scope="module")
def jax_run():
    return run_jax(N_FRAMES_BP)


@pytest.fixture(scope="module")
def port_run(jax_run):
    return run_port(jax_run[2], N_FRAMES_BP)


def test_train_chunks_match_jax_at_n_frames_bp_3(jax_run, port_run):
    want = jax_run[0]
    got, _ = port_run
    assert losses_within(got, want) == []
    assert all(np.isfinite(v) for v in got[1].values())


def test_the_bptt_length_reaches_the_losses(jax_run, port_run):
    """n_frames_bp 1 and 3 give other generator gradients from chunk 1 on:
    the BPTT length is seen by the bound."""
    got_bp3, _ = port_run
    got_bp1, _ = run_port(jax_run[2], 1)
    assert abs(got_bp1[0]["G_grad_norm"] - got_bp3[0]["G_grad_norm"]) > (
        5e-3 * got_bp3[0]["G_grad_norm"])


def test_remat_gives_the_same_step(jax_run, port_run):
    """torch.utils.checkpoint around each scale recomputes the forward in the
    backward: the same losses, grad norms and updated weights."""
    got, (gen_sd, eng_sd) = port_run
    got_remat, (gen_sd_r, eng_sd_r) = run_port(jax_run[2], N_FRAMES_BP, remat=True)
    for chunk, chunk_r in zip(got, got_remat):
        assert chunk.keys() == chunk_r.keys()
        for k in chunk:
            np.testing.assert_allclose(chunk_r[k], chunk[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for sd, sd_r in ((gen_sd, gen_sd_r), (eng_sd, eng_sd_r)):
        for k in sd:
            torch.testing.assert_close(sd_r[k], sd[k], rtol=1e-5, atol=1e-7)


def test_recipe_structure_trains_whole_clips():
    """The 512x256 recipe's options at a tiny width: label ids with instance
    maps and fg, two temporal scales, bf16 generator forward, remat, four
    chunks of two frames per clip (the coarser temporal scale's first group,
    frames 0, 3 and 6, ends in the fourth); every loss finite, G's and D's
    weights move, the norms' running stats stay until refresh_batch_stats."""
    opt = Options(
        label_nc=4, use_instance=True, fg=True, fg_labels=(1,), ngf=8,
        n_downsample_G=1, n_blocks=1, n_scales_spatial=1, n_frames_G=3,
        n_frames_D=3, n_scales_temporal=2, ndf=8, num_D=2, n_layers_D=2,
        n_frames_total=6, max_frames_per_gpu=2, norm="batch", bf16=True,
        remat=True, isTrain=True,
    )
    trainer = Trainer(opt, device="cpu")
    state = trainer.init_state()
    labels, frames = (torch.from_numpy(a) for a in
                      moving_square_clip(np.random.default_rng(0), 10, 32, 64, 4))
    before = {k: v.clone() for k, v in
              list(trainer.gen.state_dict().items()) + list(trainer.engine.state_dict().items())}
    chunks = []
    trainer.train_chunk = _counting(trainer.train_chunk, chunks)
    state, losses = trainer.train_clip(state, labels, frames, labels)
    assert len(chunks) == 4
    assert {"D_T_real1", "G_T_GAN1"} <= losses.keys()  # the coarser scale ran
    assert all(np.isfinite(v) for v in losses.values())
    after = {**trainer.gen.state_dict(), **trainer.engine.state_dict()}
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert any(k.startswith("G0.") and k.endswith("weight") for k in moved)
    assert any(k.startswith("netD.") for k in moved)
    assert not any("running" in k for k in moved)
    assert not any(k.startswith("vgg.") for k in moved)
    lr = state.opt_g.param_groups[0]["lr"]
    state = trainer.end_of_epoch(state)
    assert trainer.schedule.epoch == 2 and state.opt_g.param_groups[0]["lr"] == lr
    refresh_batch_stats(trainer, state, [(labels, frames, labels)], n_batches=1)
    assert any("running_mean" in k and not torch.equal(before[k], v)
               for k, v in trainer.gen.state_dict().items())


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return wrapped
