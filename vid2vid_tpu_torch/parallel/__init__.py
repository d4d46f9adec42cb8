"""The device mesh on torch.distributed (the port of vid2vid_tpu/parallel):
the data axis, and the model axis for serving (halo.py)."""

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
