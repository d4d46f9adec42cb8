"""The device mesh on torch.distributed (the port of vid2vid_tpu/parallel):
the data axis, and the model axis (halo.py) for serving and training;
collectives.py holds the collectives and their one-process version."""

from vid2vid_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_width,
    all_reduce_max,
    all_reduce_mean,
    all_reduce_sum,
    init_process_group,
    launch,
    make_mesh,
    replicated,
    shard_batch,
    visible_devices,
)
