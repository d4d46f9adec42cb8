"""The port's training loop against the JAX package's, on the CPU, in f32.

Two chunks of `Trainer.train_chunk` in both packages from the same weights
and the same clip (tests/torch_parity.py), at n_frames_bp 1: every loss
scalar and every optimizer group's grad norm within
tests/test_train_oracle.py's bounds, and the parameters after the first
chunk's three Adam steps. A broken copy of the port (no truncated-BPTT
detach; discriminators normalizing with running stats) leaves the bounds.
n_frames_bp 3 and remat are in test_torch_train_bptt.py.
"""

import numpy as np
import pytest

from torch_parity import LR, losses_within, run_jax, run_port
from vid2vid_tpu.utils.torch_import import (
    apply_mapping,
    composite_generator_mapping,
    multiscale_discriminator_mapping,
)
from vid2vid_tpu_torch.models.generator import Vid2VidGenerator

N_FRAMES_BP = 1


@pytest.fixture(scope="module")
def jax_run():
    return run_jax(N_FRAMES_BP)


def test_train_chunks_match_jax(jax_run):
    want, jax_after, jax_init = jax_run
    got, (gen_sd, eng_sd) = run_port(jax_init, N_FRAMES_BP)
    assert losses_within(got, want) == []
    assert all(np.isfinite(v) for v in got[1].values())

    # the parameters after chunk 1's G, D and D_T Adam steps. Deltas sit on
    # near-zero-gradient weights, whose first Adam step is sign-like (each
    # ~2*lr); a wrong lr, group or eps moves the mean by O(lr)
    def sd(d, prefix):
        return {k[len(prefix):]: v.numpy() for k, v in d.items() if k.startswith(prefix)}

    d_map = multiscale_discriminator_mapping(2, 2, "batch")
    for tree_t, tree_j in (
        (apply_mapping(sd(gen_sd, "G0."), composite_generator_mapping(2, 2, "batch")),
         jax_after.gparams["G0"]),
        (apply_mapping(sd(eng_sd, "netD."), d_map), jax_after.dparams["D"]),
        (apply_mapping(sd(eng_sd, "netD_T.0."), d_map), jax_after.dparams["D_T0"]),
    ):
        leaves_t, leaves_j = _leaves(tree_t["params"]), _leaves(tree_j["params"])
        deltas = [np.abs(a - np.asarray(b)) for a, b in zip(leaves_t, leaves_j)]
        assert len(deltas) == len(leaves_j) > 0
        assert sum(d.sum() for d in deltas) / sum(d.size for d in deltas) < 0.25 * LR
        assert max(d.max() for d in deltas) < 3.0 * LR


def _leaves(tree: dict) -> list:
    return [v for k in sorted(tree) for v in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("broken", ["no_bptt_detach", "d_running_stats"])
def test_a_broken_port_leaves_the_bounds(jax_run, broken, monkeypatch):
    """The bounds see each of two faults: the frame pass without its BPTT
    detach (the generator's gradient then runs through the previous
    frames), and discriminators that normalize with their running stats
    instead of the batch's."""
    want, _, jax_init = jax_run
    if broken == "no_bptt_detach":
        frame_pass = Vid2VidGenerator._frame_pass

        def no_detach(self, *args, **kwargs):
            return frame_pass(self, *args, **{**kwargs, "detach_prev": False})

        monkeypatch.setattr(Vid2VidGenerator, "_frame_pass", no_detach)
    else:
        from vid2vid_tpu_torch.nn.discriminator import MultiscaleDiscriminator

        forward = MultiscaleDiscriminator.forward

        def running_stats(self, x):
            self.eval()
            return forward(self, x)

        monkeypatch.setattr(MultiscaleDiscriminator, "forward", running_stats)
    got, _ = run_port(jax_init, N_FRAMES_BP)
    assert losses_within(got, want) != []

