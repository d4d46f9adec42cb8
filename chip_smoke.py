"""On-card smoke test of the PyTorch / CUDA port (vid2vid_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (one stdout line each, or a few; any failure raises and exits
non-zero):
  1. device: name, power limit, torch / CUDA versions;
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds, ptxas report);
     one line per kernel of the tensor-core body (csrc/conv_wgmma.cuh, bf16
     and f32 as 3xTF32, K = 3 and 7) with its registers, spills, shared
     memory and HGMMA count (cuobjdump -sass); fails without HGMMA or with
     spills there, or with a bf16 CUDA-core 3x3 left; one line for each
     correlation kernel, forward and backward (registers, spills, shared
     memory, blocks an SM), which fails on spills or on fewer blocks an SM
     than its plan assumes; one line for each instantiation of the warp
     forward (csrc/warp_blend.cu::warp_kernel: registers, spills, its own
     shared memory and the plan's box budget a block at 1024x2048, blocks
     an SM);
  3. kernels vs their plain PyTorch versions at the paths' shapes, with
     the tolerances below: respair and warp_blend (label2city) in f32 and
     bf16, correlation and its backward (FlowNetC, f32, at FlowNetC's
     training shape, the FlowNet2 shapes and two of the forward tile's
     edges, the backward also at four of its tile's edges, each the same
     bit for bit on a second launch), flow_warp
     (FlowNet2, f32 and bf16),
     the warp backward (training): warp_blend's and flow_warp's, conv7 at
     the single-image nets' 7x7 stems and heads, and conv3 / conv3_fused
     at the label2city path's 3x3 stride-1 convs, in f32 and bf16; and
     every f32 respair and conv7 shape of the single-image paths on each
     f32 body (tensor cores, CUDA cores) forced in turn, both max abs errs
     printed; the warp forwards at their path shapes on a smooth flow too,
     each also under the staged tile (forced), the direct tile and the
     staged tile with the largest budget: all bit for bit, and the tiles
     each staged equal to ops/warp.py::staged_tiles's count;
  3b. after each path below: each kernel against its plain version again,
     on seeded operands, at every (shapes, dtype) that path gave it and no
     earlier check held (the paths' calls are logged by shape);
  4. small-input references: the port on the card (kernels) against the
     port on the CPU (plain versions), same weights, f32: the label2city
     generator (its 7x7 stems and heads through conv7), the FlowNet2
     FlowEstimator (4b), two training chunks (4c), the single-image
     seeding of both registries (4d) and one FlowNetC training step of the
     flow harness (4e: loss, EPE and every gradient);
  5. the label2city path: the flagship configuration at 2048x1024
     (3 scales, ngf 128, fg, instance edges, bf16) streaming frames through
     InferenceEngine.step, with every kernel's launch count checked (conv7:
     the composite's 21 7x7 stems and heads a frame), a profile of one
     frame (utils/profiling.py::profile_by_family), a Chrome trace of another
     (utils/profiling.py::trace, summarize_trace: our families' ms against
     the profile's within 5%), and an A/B of the frame with those convs on
     conv7 and on cuDNN (in turns: cuDNN, conv7, conv7, cuDNN);
  5c. the same configuration streaming an 8-frame clip through
     InferenceEngine.generate_clip_raw (labels on the host, one frame
     encoded a step into a window on the card): launch counts, its frames
     and state against the step loop's, ms per frame of both in turns, and
     its peak memory against encode + generate_clip;
  5b. the FlowNet2 reference-flow path: FlowEstimator at full FlowNet2
     width (162.5M parameters, f32) on (B=1, T=2) pairs of 1024x2048
     frames, with every kernel's launch count checked;
  7. the training path: Trainer.train_clip at the 512x256 label2city
     training recipe's full width (ngf 128, bf16 generator, remat, two
     temporal scales) with the FlowEstimator reference flow, timed per
     chunk, with the kernels' launch counts and a torch.profiler breakdown
     of one chunk's device time by kernel family;
  7b. the training CLI at the same recipe (train_cli.train on two 8-frame
     synthetic clips in TemporalDataset's item layout, with the training
     phase's seeded FlowEstimator): one epoch of 6 chunks, the visuals dumped
     (--no_html), `latest` saved once (~5 GB, in a temporary directory
     removed after); restored into a fresh Trainer bit for bit (weights,
     Adam moments and steps, learning rates, schedule); one chunk from the
     restored and one from the live state within the chunk-1 bounds; the
     saved generator loaded by test_cli.load_weights and 4 frames streamed
     in bf16 with test_cli.stream_frames (respair and conv7 launched);
  8a. the edge2face path at 512x512 with --use_single_G: the first two
     frames from GlobalWithFeatures fed by the Encoder and the face-feature
     lookup (f32), then the single-scale stream (ngf 128, bf16);
  8b. the label2city 2048x1024 path seeded by the LocalEnhancer (f32),
     then the flagship stream; the peak memory and the largest cuDNN
     workspace of a seeding call and a frame, under PyTorch's default TF32
     flags and with TF32 off;
  6. kernel, plain and library-call times at the paths' shapes, and each
     kernel's bound (the least time the card could take for its work);
     respair, conv3 and conv3_fused per shape with TFLOP/s, the share of
     the bound and the ratio to cuDNN; respair (3xTF32 on the tensor
     cores) and conv7 in f32 at the single-image paths' shapes, conv7 with
     both f32 bodies forced in turns (the same-run A/B that sets
     ops/conv7.py::conv7_body's rule), beside cuDNN (TF32 off), the FFMA
     and the 3xTF32 bounds; conv7 in bf16 at the
     flagship composite's 21 7x7 shapes against cuDNN, with TFLOP/s and the
     share of the bound;
     the warps' device time (profiler) and per-call time (events over 200
     back-to-back calls) beside grid_sample's, alone and with the blend,
     on an i.i.d. flow (8 px a pixel) and on a smooth one (8 px every 16
     pixels, upsampled: tools/warp_plans.py::smooth_flow), with the bound,
     its share and the share of tiles staged (staged_tiles);
     and the warp backward's the same way (its memset and cast counted);
     the correlation per shape with TFLOP/s, the share of its FFMA bound
     (one FMA per tap inside the image), the f2 stagings per value and its
     channel split; its backward at FlowNetC's training shape against the
     plain VJP and at two more shapes, with TFLOP/s, its bound (the same
     count), its grid's blocks and waves, the FMAs it executes and its
     FMAs per shared-memory word;
  9. flow-net training: FlowNetC through FlowHarness at batch 8 on 384x512
     pairs, 5 timed steps in f32 and 5 with mixed precision (median ms a
     step, peak memory, one correlation forward and one backward a step,
     the f32 convs without TF32), a profile of one f32 step by kernel family
     with the backward kernel's share, the casts around the correlation
     under bf16 timed beside its kernels, and `fit` over two in-memory
     datasets for 2 epochs with its best checkpoint restored bit for bit;
  10. the serving artifact (tools/export.py): the flagship configuration of
     phase 5 exported through torch.export on the card (its kernels as the
     operators torch.ops.v2v.respair / conv7 / warp_blend), saved, loaded,
     and 4 frames streamed through it and InferenceEngine.step in turns:
     frames and state within CLIP_TOL, 45 / 21 / 3 launches a frame, ms a
     frame of both, export and load seconds, the artifact's bytes, the
     graph's operator nodes, peak memory;
  11. the training ledger (tools/train_ledger.py) at the 512x256 recipe:
     steady and serialized ms per iteration, each step's ms, FLOPs
     (FlopCounterMode), bound and share of it; no respair or conv7 in the G
     step, one correlation a chunk;
  12. the data axis (vid2vid_tpu_torch/parallel, --n_devices): pose2body
     256p training at full width (recipes/pose/train_256p.sh, cut to batch
     2 on 2 ranks and one clip of 2 chunks) through parallel.launch, every
     training under deterministic algorithms: one rank over NCCL bit for
     bit with the plain Trainer, two ranks over gloo on this one card with
     equal weights bit for bit, chunk 1's weight displacement within
     DDP_DISPLACEMENT_REL_L2 of one process's at batch 2 and the losses
     within the training bounds of it (their chunk 2 restarted from its
     state after chunk 1); ms a chunk per rank, each gradient bucket's
     all-reduce ms and bytes, peak memory per rank; the ranks send their
     launch counts and kernel call shapes back for 3b. Two ranks on one
     card give no scaling figure;
  13. the model axis for serving (parallel/halo.py, --n_devices 2 on
     InferenceEngine): the flagship configuration at its full 2048x1024
     width on two gloo ranks on this one card, each on its 1024 columns,
     through generate_clip_raw and the step loop on a 3-frame clip, and a
     3-frame clip at 1024x1440 (the coarsest trunk's 45 columns split 22 /
     23): the ranks' whole frames within SHARD_TOL of the unsharded
     engine's (same seed) and equal to each other bit for bit; every
     respair, conv7 and warp_blend launch of the frames in its column-halo
     mode (45 / 21 / 3 a frame a rank), their calls sent back for 3b; each
     mode bit for bit with the unsharded call on the whole tensor and
     within TOL of its plain version at flagship shapes, odd local widths
     and 1-column shards on 8, and timed; ms a frame per rank of both entry
     points, the halo exchanges and gathers and their bytes a frame, the
     ms of one exchange and one gather at three flagship shapes, peak
     memory per rank, and tools/shard_serve_bench.py's A / B / C (2 ranks
     on this card). Two ranks on one card give no scaling figure;
  14. training's model axis (parallel/halo.py, --n_devices 2 at batch 1 on
     Trainer and train_cli: data 1 x model 2): the 512x256 training recipe
     of phase 7 at its full width on two gloo ranks on this one card, each
     on its 256 columns of every frame (the generator, netD, every netD_T,
     VGG, the losses, and FlowNet2 with its confidence from the whole
     frames: FlowNetC's correlation in its column-halo mode,
     v2v_correlation_cols, counted on correlation_halo; no unsharded
     correlation or flow_warp launch on a rank), one clip of 2 chunks,
     and one f32 chunk at 256x520 (the trunk's 65 columns split 32 / 33):
     chunk 1 within the training bounds of the unsharded Trainer (same
     seeds), the ranks' weights equal bit for bit after every chunk, netD's
     finest layer on the rank's columns; every blend of the ranks'
     generator at its column offset forward and backward (warp_blend_at,
     warp_blend_at_bwd: v2v_warp_blend_bwd with Wp and x0) and every loss
     warp too (flow_warp with x0, counted on flow_warp_at and
     flow_warp_at_bwd: v2v_flow_warp_at and its backward), their calls sent
     back for 3b; the offset entries against their plain versions, the
     unsharded calls (x0 = 0) and the whole frame's columns, timed (and
     untimed at odd and 1-column widths); ms a chunk a rank against the
     unsharded Trainer run before, the exchanges and gathers a chunk
     forward and backward with their bytes, each collective's host time a
     chunk by the function that made it (collective_times), the G
     gradients' reduction ms and bytes, peak memory a rank by training
     step beside the unsharded Trainer's; then
     train_cli.train for one epoch on both ranks (equal weights, `latest`
     written once); then the ranks' sharded FlowEstimator on two pairs at
     256x512 and at 256x520 (resized to 512 and back) against the
     unsharded one (flow within 1e-4 (1 + max|flow|), the confidence equal
     away from its threshold), with the exchanges and bytes of a call and
     its ms a rank; the column-halo correlation against its plain version
     and the unsharded kernel's columns (bit for bit where the plans
     agree) at narrow, 1-column and empty shards, and timed at the
     recipe's (2, 256, 32, 64) on 2 shards against the unsharded call.
     Two ranks on one card give no scaling figure.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.
Long tables go to build/chip_smoke_profile*.txt.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

from vid2vid_tpu_torch import test_cli, train_cli  # noqa: E402
from vid2vid_tpu_torch.config import Options  # noqa: E402
from vid2vid_tpu_torch.data import face, pose, raster  # noqa: E402
from vid2vid_tpu_torch.data.synthetic import (  # noqa: E402
    densepose_iuv,
    face_image,
    face_landmarks,
    moving_square_clip,
    openpose_person,
)
from vid2vid_tpu_torch.data.transforms import get_img_params, target_size  # noqa: E402
from vid2vid_tpu_torch.kernels import build  # noqa: E402
from vid2vid_tpu_torch.models.flownet2.harness import FlowHarness  # noqa: E402
from vid2vid_tpu_torch.models.flownet2.nets import FlowNetC, init_flownet_weights  # noqa: E402
from vid2vid_tpu_torch.models.flownet2.wrapper import FlowEstimator  # noqa: E402
from vid2vid_tpu_torch.models.inference import InferenceEngine  # noqa: E402
from vid2vid_tpu_torch.nn.layers import ReflectConv7, init_weights  # noqa: E402
from vid2vid_tpu_torch.nn.pix2pixhd import LocalEnhancer  # noqa: E402
from vid2vid_tpu_torch.parallel import halo, launch, mesh  # noqa: E402
from vid2vid_tpu_torch.parallel.workers import deterministic_algorithms, run_chunks  # noqa: E402
from vid2vid_tpu_torch.ops.conv3 import (  # noqa: E402
    conv3_fused_padded,
    conv3_fused_plain,
    conv3_padded,
    conv3_plain,
    pack_conv3_weight,
)
from vid2vid_tpu_torch.ops.conv7 import (  # noqa: E402
    CUDA_CORES,
    TENSOR_CORES,
    conv7_halo,
    conv7_halo_plain,
    conv7_padded,
    conv7_plain,
    conv7_reflect,
    conv7_reflect_plain,
    conv7_body,
    forced_conv7_body,
    pack_conv7_weight,
    pack_for_kernel,
)
from vid2vid_tpu_torch.ops.correlation import (  # noqa: E402
    BWD_BLOCKS_PER_SM,
    BWD_ROWS,
    BWD_SMEM_BYTES,
    BWD_THREAD_CHANNELS,
    BWD_THREADS,
    KERNEL_MAX_DISPLACEMENT,
    KERNEL_RADIUS,
    TILE_BLOCKS_PER_SM,
    TILE_SMEM_BYTES,
    TILE_THREADS,
    correlation,
    correlation_backward_plain,
    correlation_bwd,
    correlation_bwd_fmas,
    correlation_bwd_plan,
    correlation_halo,
    correlation_halo_plain,
    correlation_plain,
    correlation_plan,
    correlation_taps,
    f2_stagings,
)
from vid2vid_tpu_torch.ops.respair import (  # noqa: E402
    respair,
    respair_halo,
    respair_halo_plain,
    respair_plain,
)
from vid2vid_tpu_torch.ops.warp import (  # noqa: E402
    flow_warp,
    flow_warp_at,
    flow_warp_at_bwd,
    flow_warp_backward_plain,
    flow_warp_bwd,
    flow_warp_plain,
    warp_blend,
    warp_blend_at,
    warp_blend_at_backward_plain,
    warp_blend_at_bwd,
    warp_blend_at_plain,
    warp_blend_backward_plain,
    warp_blend_bwd,
    warp_blend_plain,
    MAX_BOX_BYTES,
    plan_threads,
    staged_tiles,
    tile_plan,
    warp_forward_cuda,
    warp_forward_plan,
)
from vid2vid_tpu_torch.train.checkpoints import (  # noqa: E402
    restore_checkpoint,
    schedule_fields,
)
from vid2vid_tpu_torch.tools import export, shard_serve_bench, train_ledger  # noqa: E402
from vid2vid_tpu_torch.tools.warp_plans import iid_flow, smooth_flow  # noqa: E402
from vid2vid_tpu_torch.tools.train_ledger import RECIPE as TRAIN_RECIPE  # noqa: E402
from vid2vid_tpu_torch.train.loop import Trainer  # noqa: E402
from vid2vid_tpu_torch.utils.profiling import (  # noqa: E402
    COUNTERS,
    DEVICE_TIME,
    open_window,
    profile_by_family,
    read_launches,
    summarize_trace,
    trace,
)

DEV = torch.device("cuda", 0)
OUT_DIR = "build"  # listed in .gitignore

# (C, H, W, calls per frame) of every respair on the main path at 2048x1024
RESPAIR_SHAPES = [
    (1024, 32, 64, 18), (512, 32, 64, 9),
    (128, 256, 512, 6), (64, 256, 512, 3),
    (64, 512, 1024, 6), (32, 512, 1024, 3),
]
# (C, H, W, calls per seeding call, path) of every f32 respair on the
# single-image paths: GlobalWithFeatures' trunk (512 + 16 features at
# 64x64) on edge2face 512x512; the LocalEnhancer's global trunk (C = 1024 at
# H x W = 32x64) and enhancer blocks (C = 64 at 512x1024) on label2city
# 2048x1024 (H = 1024, W = 2048)
RESPAIR_F32_SHAPES = [
    (528, 64, 64, 18, "edge2face_single"),
    (1024, 32, 64, 18, "label2city_single"), (64, 512, 1024, 6, "label2city_single"),
]
# (C, H, W) of the pose2body 256p stream's trunk (256x192 / 8): a grid
# width the bodies see on no other path, checked first
POSE_RESPAIR = (1024, 32, 24)
# (H, W) of the three warp + blend calls per frame
WARP_SHAPES = [(256, 512), (512, 1024), (1024, 2048)]
# (B, C, H, W) of FlowNetC's correlation: FlowEstimator on two 1024x2048
# pairs (the first, the shape of the FlowNet2 phase), then the 1024x512 and
# 512x256 training recipes' pairs
CORR_SHAPES = [(2, 256, 128, 256), (2, 256, 64, 128), (2, 256, 32, 64)]
# (B, C, H, W) of FlowNetC's correlation operands when it trains at batch 8
# (the reference flownet2_pytorch/main.py's default --batch_size) on
# 384x512 pairs (FlyingChairs' frame): the conv3 features at 1/8
FLOW_TRAIN_BATCH, FLOW_TRAIN_HW = 8, (384, 512)
CORR_TRAIN_SHAPE = (FLOW_TRAIN_BATCH, 256, FLOW_TRAIN_HW[0] // 8, FLOW_TRAIN_HW[1] // 8)
# two of the correlation tile's edges (ops/correlation.py::TILE_*): W not a
# multiple of the 64-column tile, C not a multiple of the 16-channel chunk,
# rows of a parity not a multiple of 4, W odd
CORR_EDGE_SHAPES = [(1, 17, 13, 70), (2, 9, 22, 131)]
# the backward tile's edges (ops/correlation.py::BWD_*): C one past the
# 64-channel block and two blocks and a bit, H not a multiple of 2 *
# BWD_ROWS, W not a multiple of the 64-column tile with W % 4 == 0 (its
# 16-byte stores) or odd
CORR_BWD_EDGE_SHAPES = [(1, 70, 9, 66), (2, 65, 12, 20), (2, 130, 19, 131), (1, 256, 47, 68)]
# the backward's other timed shapes, grids of 1.94 and 0.48 waves against
# the training shape's 2.91 (the backward runs only in flow-net training)
CORR_BWD_TIMED = [(2, 256, 64, 128), (2, 256, 32, 64)]
# (B, C, H, W) of FlowNet2's five unfused warps per FlowEstimator call
FLOW_WARP_SHAPE = (2, 3, 1024, 2048)
# (net, Ci, Co, H, W) of the 7x7 convs per single-image frame: edge2face
# 512x512 (GlobalWithFeatures, 15 edge + 16 feature channels; the Encoder),
# then label2city 2048x1024 (the LocalEnhancer's global stem at 1024x512,
# its enhancer stem and head)
CONV7_SHAPES = {
    "edge2face_single": [("G stem", 31, 64, 512, 512), ("G head", 80, 3, 512, 512),
                         ("E stem", 3, 16, 512, 512), ("E head", 16, 16, 512, 512)],
    "label2city_single": [("global stem", 35, 64, 512, 1024),
                          ("enhancer stem", 35, 32, 1024, 2048),
                          ("head", 32, 3, 1024, 2048)],
}
# (Ci, Co, H, W) of the flagship composite's 7x7 stems and heads per
# 2048x1024 frame (nn/composite.py): per scale the label, previous-frame and
# fg stems, the img / flow / weight / fg heads
COMPOSITE_CONV7 = [
    shape for ngf, h, w in ((128, 256, 512), (64, 512, 1024), (32, 1024, 2048))
    for shape in ((108, ngf, h, w), (6, ngf, h, w), (108, ngf // 2, h, w),
                  (ngf, 3, h, w), (ngf, 2, h, w), (ngf, 1, h, w), (ngf // 2, 3, h, w))
]
# the warp backward's checks: (kernel, (B, C, H, W), dtype). The training
# path's shapes at 512x256 (the generator's blend per frame, the F_Warp
# loss over the chunk's two frames) and one 1024x2048 shape
BWD_CHECKS = [
    ("warp_blend_bwd", (2, 3, 256, 512), torch.bfloat16),
    ("warp_blend_bwd", (2, 3, 256, 512), torch.float32),
    ("flow_warp_bwd", (2, 3, 256, 512), torch.float32),
    ("flow_warp_bwd", (2, 3, 1024, 2048), torch.float32),
]
# (kernel, (B, C, H, W), dtype, calls per training chunk) on the training
# path: two blends of one frame each in bf16, one F_Warp loss in f32
BWD_PATH = {
    "warp_blend_bwd": ((1, 3, 256, 512), torch.bfloat16, 2),
    "flow_warp_bwd": ((2, 3, 256, 512), torch.float32, 1),
}

# Tolerances, kernel vs plain on the same inputs. The plain reference runs
# in f32 with TF32 off. bf16: the kernel's inputs are bf16 and the plain
# version runs in f32 on the same (upcast) values. The warp bf16 bound adds
# rtol 4e-3 to atol 1e-2: the kernel's only rounding is the final store to
# bf16, up to 2**-8 of the value, which exceeds 1e-2 where |out| > 2.56.
# The backward's image gradient sums with f32 atomics in an order that
# changes from run to run: f32 rounding of up to ~100 terms of O(1) where
# the border gathers many samples, hence atol 1e-4 + rtol 1e-5; in bf16 the
# store to bf16 adds up to 2**-8 of the value.
TOL = {
    ("respair", torch.float32): dict(atol=1e-3, rtol=1e-4),
    ("respair", torch.bfloat16): dict(atol=5e-2, rtol=2e-2),
    ("warp_blend", torch.float32): dict(atol=1e-5, rtol=0.0),
    ("warp_blend", torch.bfloat16): dict(atol=1e-2, rtol=4e-3),
    ("flow_warp", torch.float32): dict(atol=1e-5, rtol=0.0),
    ("flow_warp", torch.bfloat16): dict(atol=1e-2, rtol=4e-3),
    # the correlation is a multiply-sum on the CUDA cores in both versions
    # (TF32 never touches it); only the summation order differs
    ("correlation", torch.float32): dict(atol=1e-5, rtol=1e-5),
    # its backward likewise: each gradient element sums 441 products in f32,
    # the kernel in displacement order, the plain autograd plane by plane
    ("correlation_bwd", torch.float32): dict(atol=1e-5, rtol=1e-5),
    ("warp_blend_bwd", torch.float32): dict(atol=1e-4, rtol=1e-5),
    ("warp_blend_bwd", torch.bfloat16): dict(atol=1e-2, rtol=8e-3),
    ("flow_warp_bwd", torch.float32): dict(atol=1e-4, rtol=1e-5),
    # one conv each, summed in f32 in another order than cuDNN's (up to
    # 49 * 80 or 9 * 1024 products of O(1 / sqrt(n)) terms); in bf16 the
    # only rounding is the final store, up to 2**-8 of the value
    ("conv7", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("conv7", torch.bfloat16): dict(atol=1e-2, rtol=8e-3),
    ("conv3", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("conv3", torch.bfloat16): dict(atol=1e-2, rtol=8e-3),
    ("conv3_fused", torch.float32): dict(atol=1e-4, rtol=1e-4),
    ("conv3_fused", torch.bfloat16): dict(atol=1e-2, rtol=8e-3),
}
KERNELS = {"respair": respair, "warp_blend": warp_blend,
           "flow_warp": flow_warp, "correlation": correlation,
           "correlation_bwd": correlation_bwd,
           "warp_blend_bwd": warp_blend_bwd, "flow_warp_bwd": flow_warp_bwd,
           "conv7": conv7_reflect, "conv3": conv3_padded,
           "conv3_fused": conv3_fused_padded}
PLAIN = {"respair": respair_plain, "warp_blend": warp_blend_plain,
         "flow_warp": flow_warp_plain, "correlation": correlation_plain,
         "correlation_bwd": correlation_backward_plain,
         "warp_blend_bwd": warp_blend_backward_plain,
         "flow_warp_bwd": flow_warp_backward_plain,
         "conv7": conv7_reflect_plain, "conv3": conv3_plain,
         "conv3_fused": conv3_fused_plain}
# the plain versions of second entries: conv7's pre-padded entry, and the
# column-halo and offset modes of a width shard (phases 13 and 14)
PLAIN_OF = {conv7_padded: conv7_plain, conv7_halo: conv7_halo_plain,
            respair_halo: respair_halo_plain, warp_blend_at: warp_blend_at_plain,
            warp_blend_at_bwd: warp_blend_at_backward_plain,
            flow_warp_at: flow_warp_plain, flow_warp_at_bwd: flow_warp_backward_plain,
            correlation_halo: correlation_halo_plain}
# the wrappers that their own module calls, from an autograd backward: the
# path logs their calls there too (kernel_call_shapes)
CALLED_IN_THEIR_MODULE = {"correlation_bwd", "warp_blend_at_bwd", "flow_warp_bwd",
                          "correlation_halo"}
# the unfused warp's entries whose launches on a width shard's columns (the
# flow narrower than the image) count on a counter of their own: a path's
# call is logged under that counter (LoggedCall)
SHARD_ENTRY = {flow_warp: flow_warp_at, flow_warp_bwd: flow_warp_at_bwd}
# phase 9's times of the f32 casts around the correlation kernels under
# bf16, and of the kernels at the same shape (the correlation JSON row)
FLOW_TRAIN_CASTS: dict = {}
# call_key of every kernel call compare() has held against its plain version
CHECKED: set = set()
# the launch counts of each single-image path's timed seeding calls alone
SEED_LAUNCHES: dict = {}
# the H100 SXM's published peaks (dense): HBM bytes/s; FLOP/s in bf16 on
# the tensor cores and in f32 on the CUDA cores; f32-class products on the
# tensor cores as 3xTF32: three tf32 products (495 TFLOP/s) per product
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
TF32X3_FLOPS = 495e12 / 3
BODIES = {"tensor_cores": TENSOR_CORES, "cuda_cores": CUDA_CORES}  # the f32 7x7 bodies
# the max abs err of the f32 7x7 convs at the single-image paths' shapes on
# the body the rule does not pick (phase 3)
OTHER_BODY_ERRS: dict = {}
# The f32 tensor-core body's own bound, held in phase 3 beside TOL (which is
# looser): 3xTF32 keeps each product to ~2**-21 of its value, and at the
# single-image paths' shapes it reads <= 2.2e-5 against the plain version
# on the H100. A body that drops accumulation bits (the per-chunk f32
# register set added to the accumulator once the chunk is done) read 2.8e-4
# at C = 528 and 4.7e-4 at C = 1024; a single TF32 pass misses by ~1e-3.
F32_TENSOR_CORE_ERR = 1e-4
# generate_clip_raw against the step loop on the same seeded state (phase
# 5c): both run the same kernels on the same bf16 values, so the frames may
# differ only by bf16 rounding in another order: one bf16 ulp of a frame
CLIP_TOL = dict(atol=1e-2, rtol=8e-3)
FLAGSHIP = dict(
    label_nc=35, use_instance=True, fg=True, fg_labels=(26,), ngf=128,
    n_downsample_G=3, n_blocks=9, n_blocks_local=3, n_scales_spatial=3,
    n_frames_G=3, norm="batch", bf16=True, pallas_resblocks=True, isTrain=False,
)
SMALL = dict(
    label_nc=4, use_instance=True, fg=True, fg_labels=(3,), ngf=32,
    n_downsample_G=2, n_blocks=3, n_blocks_local=1, n_scales_spatial=2,
    n_frames_G=3, norm="batch", isTrain=False,
)
# edge2face 512x512: bench.py's edge2face_512 (scripts/face/test_512.sh),
# with the single-image first frames of the edge2face registry
EDGE2FACE = dict(
    label_nc=0, input_nc=15, use_instance=False, fg=False, ngf=128,
    n_downsample_G=3, n_blocks=9, n_scales_spatial=1, n_frames_G=3,
    norm="batch", bf16=True, pallas_resblocks=True, isTrain=False,
    dataroot="datasets/face/", use_single_G=True,
)
# (H, W) of the two single-image paths
FACE_HW, CITY_HW = (512, 512), (1024, 2048)
# (H, W) of the training CLI's clips
TRAIN_HW = (256, 512)
# the training CLI's options on top of the recipe: every clip printed, the
# visuals dumped every second step (their numpy path; no gallery, no PIL),
# one epoch that saves only `latest`, once
TRAIN_CLI = dict(no_html=True, print_freq=1, display_freq=2, niter=1, niter_decay=0,
                 save_epoch_freq=2, name="train_cli")
# the face and pose paths (their items built in memory by the port's array
# builders, at frame sizes every resize keeps: the card's machine has no
# PIL). edge2face 512 served (recipes/face/test_512.sh): 68 landmarks whose
# crop box is the whole 512x512 frame, --use_single_G
FACE_STREAM = dict(EDGE2FACE, dataset_mode="face", loadSize=512)
FACE_STREAM_HW, FACE_WIDTH = (512, 512), 205.0  # crop side 2.5 * 205 -> 512
# pose2body 256p served (recipes/pose/test_256p.sh) in bf16 at full width:
# 256x384 frames, which scaleHeight 256 keeps; the central crop gives 256x192
POSE_STREAM = dict(
    label_nc=0, input_nc=6, use_instance=False, fg=False, ngf=128, n_downsample_G=3,
    n_blocks=9, n_scales_spatial=1, n_frames_G=3, norm="batch", bf16=True, isTrain=False,
    dataset_mode="pose", dataroot="datasets/pose/", resize_or_crop="scaleHeight",
    loadSize=256, no_first_img=True,
)
POSE_STREAM_HW = (256, 384)
# pose2body 512p training with the face discriminator
# (recipes/pose/train_512p.sh) on one card: batchSize 1, seeded weights in
# place of --load_pretrain, scaleHeight in place of randomScaleHeight (a
# resize to loadSize 768, which the 768x1364 frames keep; the scaled crop
# gives 512x896, the central crop 512x448),
# clips of 3 frames (+ tG - 1) in place of 12, one epoch of two clips (one
# without the face parts), serial batches; f32, as the recipe
POSE_TRAIN = dict(
    label_nc=0, input_nc=6, use_instance=False, fg=False, ngf=128, n_downsample_G=3,
    n_blocks=9, n_blocks_local=3, n_scales_spatial=2, num_D=3, n_frames_G=3, n_frames_D=3,
    norm="batch", isTrain=True, dataset_mode="pose", dataroot="datasets/pose/",
    resize_or_crop="scaleHeight_and_scaledCrop", loadSize=768, fineSize=512,
    no_first_img=True, n_frames_total=3, max_t_step=4, add_face_disc=True,
    niter_fix_global=3, niter=1, niter_decay=0, lr=0.0001, batchSize=1, n_devices=1,
    serial_batches=True, no_html=True, print_freq=1, display_freq=1000, save_epoch_freq=2,
    name="pose_train",
)
POSE_TRAIN_RAW_HW = (768, 1364)
# pose2body 256p training on the data axis (recipes/pose/train_256p.sh, the
# recipe whose batch 8 on 8 devices makes a data-only mesh) at full width,
# f32, with the seeded FlowEstimator: two cuts, batchSize 2 on --n_devices
# 2 in place of 8 on 8 (each rank keeps the recipe's one sample a device),
# and one clip of 2 chunks of DDP_LOAD frames (n_frames_load of the data-2
# mesh: 2 x max_frames_per_gpu); scaleHeight in place of randomScaleHeight
# (384x680 frames, which the resize to loadSize 384 keeps), serial batches
POSE_DDP = dict(
    label_nc=0, input_nc=6, use_instance=False, fg=False, ngf=128, n_downsample_G=3,
    n_blocks=9, n_scales_spatial=1, num_D=2, n_frames_G=3, n_frames_D=3, norm="batch",
    isTrain=True, dataset_mode="pose", dataroot="datasets/pose/",
    resize_or_crop="scaleHeight_and_scaledCrop", loadSize=384, fineSize=256,
    no_first_img=True, n_frames_total=12, max_frames_per_gpu=3, max_t_step=4,
    batchSize=2, n_devices=2, serial_batches=True,
)
POSE_DDP_RAW_HW = (384, 680)
DDP_LOAD = 6
DDP_DEADLINE_S = 400.0
# the most the relative L2 of the 2 ranks' chunk-1 weight displacement may
# be off the single process's: on an H100 80GB HBM3 at 700 W it read 0.2133
# as the port stands (1.15% of the moved weights the other way: Adam's
# first step moves each by ~lr whatever its gradient's size) and 1.151 with
# the ranks' batch norms left unsynced (chip_ddp_fault.py)
DDP_DISPLACEMENT_REL_L2 = 0.3
# a small training configuration for the card-vs-CPU reference (f32)
SMALL_TRAIN = dict(
    label_nc=4, use_instance=True, fg=True, fg_labels=(1,), ngf=16,
    n_downsample_G=2, n_blocks=2, n_scales_spatial=1, n_frames_G=3,
    n_frames_D=3, n_scales_temporal=1, ndf=16, num_D=2, n_layers_D=2,
    n_frames_total=6, max_frames_per_gpu=3, norm="batch", bf16=False,
    remat=False, isTrain=True, fineSize=128,
)
# every loss scalar the training reference compares, and the grad norms
TRAIN_KEYS = [
    "G_VGG", "G_GAN", "G_GAN_Feat", "G_Warp", "F_Flow", "F_Warp", "W",
    "D_real", "D_fake", "G_T_GAN0", "G_T_GAN_Feat0", "D_T_real0", "D_T_fake0",
    "loss_G_total", "loss_D_total",
]
GRAD_KEYS = ["G_grad_norm", "D_grad_norm", "D_T_grad_norm0"]


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def out_path(file_name: str) -> str:
    return os.path.join(OUT_DIR, file_name)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def respair_case(c, h, w, dtype, gen, b=1):
    x = torch.randn((b, c, h, w), generator=gen)
    k0, k1 = (torch.randn((c, c, 3, 3), generator=gen) / math.sqrt(9 * c)
              for _ in range(2))
    ab = [(1.0 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen))
          for _ in range(2)]
    x, k0, k1 = (t.to(DEV, dtype) for t in (x, k0, k1))
    ab0, ab1 = (tuple(v.to(DEV) for v in pair) for pair in ab)
    return x, k0, ab0, k1, ab1


# the warp forward's flow kinds: 8 px a pixel, i.i.d. (the yardstick the
# rows' history was timed on), or 8 px every 16 pixels, upsampled
# bilinearly (smooth, as the paths' flows are); both run past the borders
WARP_FLOWS = {"iid": iid_flow, "smooth": smooth_flow}


def warp_case(h, w, dtype, gen, b=1, c=3, flow="iid"):
    raw = torch.randn((b, c, h, w), generator=gen)
    prev = torch.randn((b, c, h, w), generator=gen)
    flow = WARP_FLOWS[flow](b, h, w, gen)
    weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=gen))
    return tuple(t.to(DEV, dtype) for t in (raw, prev, flow, weight))


def flow_warp_case(dtype, gen, shape=FLOW_WARP_SHAPE, flow="iid"):
    b, c, h, w = shape
    image = torch.randn((b, c, h, w), generator=gen)
    flow = WARP_FLOWS[flow](b, h, w, gen)
    return tuple(t.to(DEV, dtype) for t in (image, flow))


def bwd_case(name, shape, dtype, gen):
    """The backward's arguments: flows of several pixels with integer flows
    (JAX's half-gradient tie rule) on the top eighth, and a cotangent."""
    b, c, h, w = shape
    image = torch.randn((b, c, h, w), generator=gen)
    flow = 8.0 * torch.randn((b, 2, h, w), generator=gen)
    flow[:, :, : h // 8] = torch.round(flow[:, :, : h // 8])
    g = torch.randn((b, c, h, w), generator=gen)
    if name == "flow_warp_bwd":
        args = (image, flow, g)
    else:
        raw = torch.randn((b, c, h, w), generator=gen)
        weight = torch.sigmoid(torch.randn((b, 1, h, w), generator=gen))
        args = (raw, image, flow, weight, g)
    return tuple(t.to(DEV, dtype) for t in args)


def corr_case(shape, gen):
    return tuple(torch.randn(shape, generator=gen).to(DEV) for _ in range(2))


def corr_bwd_case(shape, gen):
    """f1, f2 (B, C, H, W) and a cotangent (B, 441, H, W)."""
    b, _, h, w = shape
    return (*corr_case(shape, gen), torch.randn((b, 441, h, w), generator=gen).to(DEV))


def conv7_case(ci, co, h, w, dtype, gen, b=1):
    """(x, w, bias) of a 7x7 conv: (B, Ci, H, W) input, weights of
    1 / sqrt(49 Ci) so the output is O(1), an f32 bias."""
    x = torch.randn((b, ci, h, w), generator=gen)
    wt = torch.randn((co, ci, 7, 7), generator=gen) / math.sqrt(49 * ci)
    bias = 0.1 * torch.randn(co, generator=gen)
    return x.to(DEV, dtype), wt.to(DEV, dtype), bias.to(DEV)


def conv3_cases(c, h, w, dtype, gen):
    """The 3x3 convs of one respair call at (C, H, W) as conv3 and
    conv3_fused take them: the reflect-padded input x -> h (conv3; fused:
    the ReLU form) and h -> out (fused: the residual form, with x)."""
    x, k0, (a0, c0), k1, (a1, c1) = respair_case(c, h, w, dtype, gen)
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return (xp, k0), (xp, k0, a0, c0, None, True), (xp, k1, a1, c1, x, False)


def case_at(name, shapes, dtype, gen):
    """Seeded operands of a kernel at the shapes a path gave it: `shapes`
    are those of the call's tensor arguments, in order."""
    b, c, h, w = shapes[0]
    if name == "respair":
        return respair_case(c, h, w, dtype, gen, b)
    if name == "warp_blend":
        return warp_case(h, w, dtype, gen, b, c)
    if name == "flow_warp":
        return flow_warp_case(dtype, gen, shapes[0])
    if name == "flow_warp_bwd":
        return bwd_case(name, shapes[0], dtype, gen)
    if name == "correlation":
        return corr_case(shapes[0], gen)
    if name == "correlation_bwd":
        return corr_bwd_case(shapes[0], gen)
    if name == "conv7":
        return conv7_case(c, shapes[1][0], h, w, dtype, gen, b)
    raise NotImplementedError(f"no seeded case for {name}: add one to case_at")


def halo_case(fn, shapes, dtype, gen):
    """Seeded operands of a column-halo or offset mode's call (phases 13
    and 14) at the shapes and columns a path gave it; None for any other
    wrapper."""
    if fn is conv7_halo:  # (x_in, w, bias, xoff, width, edges)
        (b, ci, h, w_in), co = shapes[0], shapes[1][0]
        return (*conv7_case(ci, co, h, w_in, dtype, gen, b), *shapes[-3:])
    if fn is respair_halo:  # (x, x_in, xoff, edges, k0, ab0, k1, ab1)
        (b, c, h, w), w_in, xoff, edges = shapes[0], shapes[1][3], shapes[2], shapes[3]
        x_in, k0, ab0, k1, ab1 = respair_case(c, h, w_in, dtype, gen, b)
        return x_in[..., xoff : xoff + w].contiguous(), x_in, xoff, edges, k0, ab0, k1, ab1
    if fn is warp_blend_at:  # (raw, prev, flow, weight, x0)
        (b, c, h, w), wp, x0 = shapes[0], shapes[1][3], shapes[-1]
        raw, prev, flow, weight = warp_case(h, wp, dtype, gen, b, c)
        raw, flow, weight = (t[..., x0 : x0 + w].contiguous() for t in (raw, flow, weight))
        return raw, prev, flow, weight, x0
    if fn is warp_blend_at_bwd:  # (raw, prev, flow, weight, g, x0)
        (b, c, h, w), wp, x0 = shapes[0], shapes[1][3], shapes[-1]
        raw, prev, flow, weight, g = bwd_case("warp_blend_bwd", (b, c, h, wp), dtype, gen)
        raw, flow, weight, g = (t[..., x0 : x0 + w].contiguous() for t in (raw, flow, weight, g))
        return raw, prev, flow, weight, g, x0
    if fn in (flow_warp_at, flow_warp_at_bwd):  # (image, flow[, g], x0)
        (b, c, h, wp), w, x0 = shapes[0], shapes[1][3], shapes[-1]
        image, flow, g = bwd_case("flow_warp_bwd", (b, c, h, wp), dtype, gen)
        flow, g = (t[..., x0 : x0 + w].contiguous() for t in (flow, g))
        return (image, flow, x0) if fn is flow_warp_at else (image, flow, g, x0)
    if fn is correlation_halo:  # (f1 (B, C, H, w), f2 (B, C, H, w + 40))
        return corr_case(shapes[0], gen)[0], corr_case(shapes[1], gen)[0]
    return None


def call_key(fn, args) -> tuple:
    """(wrapper, shapes of the tensor arguments with the int arguments in
    their places (a column-halo mode's columns), dtype of the first
    tensor)."""
    tensors = [a for a in args if torch.is_tensor(a)]
    return fn, tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args
                     if torch.is_tensor(a) or type(a) is int), tensors[0].dtype


class LoggedCall:
    """A kernel wrapper that logs each call's key into `seen` before it
    runs; its attributes (the launch counters, which a wrapper updates
    through its module's name for itself) are the wrapper's."""

    def __init__(self, name, fn, seen):
        object.__setattr__(self, "_call", (name, fn, seen))

    def __call__(self, *args, **kwargs):
        name, fn, seen = self._call
        if kwargs.get("shard") is not None:  # its column-halo entry logs the call
            return fn(*args, **kwargs)
        shard = fn in SHARD_ENTRY and args[1].shape[-1] != args[0].shape[-1]
        key = (name, *call_key(SHARD_ENTRY[fn] if shard else fn, args))
        seen[key] = seen.get(key, 0) + 1
        return fn(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._call[1], attr)

    def __setattr__(self, attr, value):
        setattr(self._call[1], attr, value)


@contextlib.contextmanager
def kernel_call_shapes():
    """Within the block, every call that a module of the port makes to a
    kernel wrapper is logged: yields {(name, wrapper, shapes, dtype): calls}.
    The names the calling modules imported are swapped for a logging shim
    and put back after; the wrapper and its launch count stay as they are."""
    names = {id(fn): name for name, fns in COUNTERS.items() for fn in fns}
    seen, swapped = {}, []

    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("vid2vid_tpu_torch."):
            continue
        for attr, val in list(vars(mod).items()):
            name = names.get(id(val))
            if name is not None and (val.__module__ != mod.__name__
                                     or attr in CALLED_IN_THEIR_MODULE):
                swapped.append((mod, attr, val))
                setattr(mod, attr, LoggedCall(name, val, seen))
    try:
        yield seen
    finally:
        for mod, attr, val in swapped:
            setattr(mod, attr, val)


def reset_launches() -> None:
    for fns in COUNTERS.values():
        for fn in fns:
            fn.launches = 0
            if hasattr(fn, "second_kernels"):
                fn.second_kernels = 0


def upcast(args):
    return [tuple(v.float() for v in a) if isinstance(a, tuple)
            else a.float() if torch.is_tensor(a) else a for a in args]


def compare(name, args, dtype, kernel=None, plain=None):
    """Max abs error of the kernel against its plain version (every output);
    raises outside the tolerance, or if the kernel did not launch. `kernel`
    / `plain` name another entry of the same kernel (conv7_padded). The
    call's key goes into CHECKED."""
    kernel = kernel or KERNELS[name]
    CHECKED.add(call_key(kernel, args))
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch")
    want = (plain or PLAIN[name])(*upcast(args))
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    tol = TOL[(name, dtype)]
    worst = 0.0
    for g, w in zip(got, want):
        err = (g.float() - w).abs()
        bad = int((err > tol["atol"] + tol["rtol"] * w.abs()).sum())
        if bad or not torch.isfinite(g).all() or g.dtype != dtype:
            raise AssertionError(
                f"{name} {tuple(args[0].shape)} {dtype}: {bad} elements outside "
                f"{tol}, max abs err {float(err.max()):.3g}, out dtype {g.dtype}"
            )
        worst = max(worst, float(err.max()))
    return worst


def time_ms(fn, args) -> float:
    """Mean device time of one call, from CUDA events over many calls."""
    for _ in range(2):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    reps = min(200, max(3, math.ceil(100.0 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_and_device_ms(fn, args, n: int = 200, fills: bool = False,
                       tries: int = 3) -> tuple[float, float]:
    """(ms per call, device ms per call) of n back-to-back calls: CUDA events
    around them (the host's time per call where it exceeds the device's),
    and the profiler's kernel rows over them, after a warm-up window; raises
    if `tries` windows all record no device time. With
    `fills` the memsets and fills count too (the warp backward zeroes its
    splat), open_window's one 4-byte fill per window included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    per_call = start.elapsed_time(end) / n
    # the profiler has lost every kernel of a window now and then (one
    # grid_sample window read 0): such a window is recorded anew
    for attempt in range(1, tries + 1):
        recorded = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: recorded.append(p.key_averages())) as prof:
            for _ in range(2):
                open_window(DEV)
                for _ in range(n):
                    fn(*args)
                torch.cuda.synchronize()
                prof.step()
        us = sum(next((getattr(e, a) for a in DEVICE_TIME if hasattr(e, a)), 0.0)
                 for e in recorded[0] if e.device_type == DeviceType.CUDA
                 and not e.key.startswith(("Command Buffer", "Memcpy"))
                 and (fills or not (e.key.startswith("Memset")
                                    or "FillFunctor" in e.key)))  # open_window's
        if us > 0:
            break
        say("profile_empty", fn=getattr(fn, "__name__", repr(fn)), window=attempt)
    else:
        raise AssertionError(f"{fn}: the profiler recorded no device time in {tries} windows")
    return per_call, us / 1e3 / n


# ------------------------------------------------ library calls and bounds


def sampling_grid(flow: torch.Tensor, x0: int = 0, wp: int | None = None) -> torch.Tensor:
    """The normalized [-1, 1] grid of flow_warp for F.grid_sample
    (align_corners=True): pixel (x + u, y + v) of (B, 2, H, W) flow; with
    x0, pixel (x0 + x + u, y + v) of an image wp columns wide (a shard's
    warp_blend_at)."""
    b, _, h, w = flow.shape
    wp = w if wp is None else wp
    ys = torch.arange(h, device=flow.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(x0, x0 + w, device=flow.device, dtype=torch.float32).view(1, 1, w)
    gx = (xs + flow[:, 0].float()) * (2.0 / (wp - 1)) - 1.0
    gy = (ys + flow[:, 1].float()) * (2.0 / (h - 1)) - 1.0
    return torch.stack([gx, gy], -1).to(flow.dtype)


def grid_sample(image, grid):
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def grid_sample_blend(raw, prev, grid, weight):
    """warp_blend in PyTorch calls: grid_sample, then the blend."""
    return raw * weight + grid_sample(prev, grid) * (1.0 - weight)


def grid_sample_backward(image, flow, g, x0: int = 0):
    """A function running F.grid_sample's autograd backward (the image's and
    the grid's gradients) for the cotangent g, on a graph built once; with
    x0, at that column offset of the whole image (sampling_grid)."""
    img = image.detach().clone().requires_grad_()
    grid = sampling_grid(flow, x0, image.shape[3]).requires_grad_()
    out = grid_sample(img, grid)
    return lambda: torch.autograd.grad(out, (img, grid), g, retain_graph=True)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def warp_work(shape, dtype, n_read_ch, n_write_ch, flop_per_elem):
    """(bytes, operations) of a warp-family call on (B, C, H, W): the
    channel counts read and written per pixel, each once."""
    b, c, h, w = shape
    size = torch.tensor([], dtype=dtype).element_size()
    return ((n_read_ch + n_write_ch) * b * h * w * size, flop_per_elem * b * c * h * w)


# ----------------------------------------------------------------- phases


def seed_net(net: torch.nn.Module, seed: int) -> None:
    """Weights from a seeded torch.Generator (on the CPU for every device)
    and seeded running stats of the batch and instance norms (mean N(0,
    0.1), var U(0.5, 1.5))."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    with torch.no_grad():
        for m in net.modules():
            if (isinstance(m, (torch.nn.BatchNorm2d, torch.nn.InstanceNorm2d))
                    and m.running_mean is not None):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=gen))


def seeded_engine(opt: Options, device, seed: int) -> InferenceEngine:
    """An engine whose generator is seeded by `seed_net`."""
    eng = InferenceEngine(opt, device=device)
    seed_net(eng.gen, seed)
    return eng


def watch_tf32(tf32_seen: list, *nets: torch.nn.Module) -> None:
    """Each forward of each net appends cuDNN's TF32 flag to `tf32_seen`."""
    for net in nets:
        net.register_forward_pre_hook(
            lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))


def seeded_flow_estimator(device, seed: int, tf32_seen: list) -> FlowEstimator:
    """FlowEstimator with the reference flow nets' initialisation drawn
    from a seeded torch.Generator (on the CPU for every device). Each
    forward of its FlowNet2 appends cuDNN's TF32 flag to `tf32_seen`."""
    est = FlowEstimator()
    init_flownet_weights(est, torch.Generator().manual_seed(seed))
    watch_tf32(tf32_seen, est.net)
    return est.to(device).eval()


@contextlib.contextmanager
def torch_default_tf32():
    """PyTorch's default TF32 flags (cuDNN on, matmul off) for the block, so
    a phase measures the precision the modules set themselves."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def check_f32_convs(tf32_seen: list, what: str = "FlowNet2") -> None:
    """The watched nets ran with TF32 off although the caller had cuDNN's
    on (inside torch_default_tf32)."""
    if not tf32_seen or any(tf32_seen) or not torch.backends.cudnn.allow_tf32:
        raise AssertionError(
            f"cuDNN TF32 inside {what} {tf32_seen}, after the call "
            f"{torch.backends.cudnn.allow_tf32}: want False inside, True after")


def frame_pairs(t: int, h: int, w: int, seed: int = 0):
    """(1, T, 3, H, W) frame pairs from numpy: each next frame is the last
    one shifted by a few pixels plus small noise, values in [0, 1]."""
    rng = np.random.default_rng(seed)
    frames = [rng.random((3, h, w), dtype=np.float32)]
    for _ in range(t):
        moved = np.roll(frames[-1], (2, 3), axis=(1, 2))
        noise = 0.02 * rng.standard_normal((3, h, w), dtype=np.float32)
        frames.append(np.clip(moved + noise, 0.0, 1.0))
    stack = torch.from_numpy(np.stack(frames))
    return stack[None, :-1].contiguous(), stack[None, 1:].contiguous()


def label_stream(opt: Options, frames: int, h: int, w: int):
    """Labels and instances from numpy seed 0, as bench.py makes them."""
    rng = np.random.default_rng(0)
    n = frames + opt.n_frames_G - 1
    labels = torch.from_numpy(rng.integers(0, opt.label_nc, (1, n, h, w)))
    inst = torch.from_numpy(rng.integers(0, 4, (1, n, h, w)))
    return labels, inst


def stub_flow(cur, prev, shard=None):
    """A deterministic stand-in for FlowNet2 on (B, T, 3, H, W) frames (the
    training reference's; tests/test_train_oracle.py uses it too); on a
    width shard, its columns."""
    d = halo.local(cur - prev, shard)
    flow = torch.stack([2.0 * torch.tanh(3.0 * d[:, :, 0]),
                        2.0 * torch.tanh(3.0 * d[:, :, 1])], 2)
    return flow, torch.sigmoid(d[:, :, 2:3])


def train_reference(n_chunks: int) -> dict:
    """n_chunks chunks of three frames of the small training configuration,
    in step on the CPU and on the card from the same seeded weights: the
    per-chunk loss dicts of each device. Before each later chunk the card
    takes the CPU's weights and Adam moments, so every chunk starts from the
    same weights: Adam's first steps move each weight by about lr whatever
    the size of its gradient, so a gradient near zero that differs in sign
    between the devices would otherwise set the weights apart by 2 lr."""
    opt = Options(**SMALL_TRAIN)
    trainers = {d: Trainer(opt, flow_fn=stub_flow, device=d) for d in ("cpu", DEV)}
    states = {d: t.init_state() for d, t in trainers.items()}
    carries = {d: t.start_clip() for d, t in trainers.items()}
    n_load = opt.max_frames_per_gpu
    t_len = n_load + opt.n_frames_G - 1
    labels, frames = moving_square_clip(
        np.random.default_rng(2), n_chunks * n_load + t_len - n_load, 64, 128, 4)
    labels, frames = torch.from_numpy(labels), torch.from_numpy(frames)
    # texture, so the VGG and warp losses see more than flat colours
    frames = (frames + 0.3 * torch.sin(torch.arange(128.0) / 5.0)).clamp(-1, 1)
    out = {d: [] for d in trainers}
    for i in range(0, n_chunks * n_load, n_load):
        for d, trainer in trainers.items():
            states[d], carries[d], losses = trainer.train_chunk(
                states[d], carries[d], labels[:, i : i + t_len],
                frames[:, i : i + t_len], labels[:, i : i + t_len])
            out[d].append(losses)
        src, dst = states["cpu"], states[DEV]
        for name in ("gen", "engine", "opt_g", "opt_d"):
            getattr(dst, name).load_state_dict(getattr(src, name).state_dict())
        for o_src, o_dst in zip(src.opt_dt, dst.opt_dt):
            o_dst.load_state_dict(o_src.state_dict())
    return out


def out_of_bounds(got: list[dict], want: list[dict],
                  keys: list[str] = TRAIN_KEYS + GRAD_KEYS) -> list[str]:
    """The keys outside tests/test_train_oracle.py's bounds: losses 2e-4
    (rtol and atol) in chunk 1 and 2e-2 in chunk 2, grad norms rtol 5e-3
    and 5e-2 with atol 5e-4."""
    bad = []
    for chunk, (g, w) in enumerate(zip(got, want)):
        tol, gtol = (2e-4, 5e-3) if chunk == 0 else (2e-2, 5e-2)
        bad += [f"chunk {chunk} {k}: {g[k]} vs {w[k]}" for k in keys
                if not (math.isclose(g[k], w[k], rel_tol=gtol, abs_tol=5e-4)
                        if "grad_norm" in k
                        else math.isclose(g[k], w[k], rel_tol=tol, abs_tol=tol))]
    return bad


def record_err(errs: dict, name, dtype, e, shape, **where) -> None:
    """Keep the largest error of a kernel in a dtype; one stdout line."""
    errs[name][dtype] = max(errs[name].get(dtype, 0.0), e)
    tol = TOL[(name, dtype)]
    say("check", kernel=name, **where, shape="x".join(map(str, shape)),
        dtype=str(dtype)[6:], max_abs_err=f"{e:.3g}",
        bound=f"{tol['atol']}+{tol['rtol']}*|plain|", ok=True)


def check_path_shapes(path: str, seen: dict, errs: dict, gen: torch.Generator) -> None:
    """Phase 3b: each kernel against its plain version, on seeded operands,
    at every (shapes, dtype) the path gave it (kernel_call_shapes) that no
    earlier check held; fails if the path called a kernel at none."""
    if not seen:
        raise AssertionError(f"{path}: no kernel call was logged")
    for (name, fn, shapes, dtype), calls in seen.items():
        if (fn, shapes, dtype) in CHECKED:
            continue
        args = halo_case(fn, shapes, dtype, gen) or case_at(name, shapes, dtype, gen)
        e = compare(name, args, dtype, fn, PLAIN_OF.get(fn))
        record_err(errs, name, dtype, e, shapes[0], path=path, calls=calls)
        del args


def check_kernels(gen: torch.Generator) -> dict:
    """Phase 3: every kernel against its plain version at its paths' shapes;
    returns the max abs errors by kernel and dtype."""
    errs = {name: {} for name in KERNELS}

    def record(name, dtype, e, shape, **where):
        record_err(errs, name, dtype, e, shape, **where)

    for dtype in (torch.float32, torch.bfloat16):
        for c, h, w in [POSE_RESPAIR] + [shape[:3] for shape in RESPAIR_SHAPES]:
            args = respair_case(c, h, w, dtype, gen)
            record("respair", dtype, compare("respair", args, dtype), (c, h, w))
        for h, w in WARP_SHAPES:
            args = warp_case(h, w, dtype, gen)
            record("warp_blend", dtype, compare("warp_blend", args, dtype), (3, h, w))
        args = flow_warp_case(dtype, gen)
        record("flow_warp", dtype, compare("flow_warp", args, dtype), FLOW_WARP_SHAPE)
        del args
        warp_forward_checks(gen, dtype, record)
    for shape in [CORR_TRAIN_SHAPE] + CORR_SHAPES + CORR_EDGE_SHAPES:
        args = corr_case(shape, gen)
        record("correlation", torch.float32,
               compare("correlation", args, torch.float32), shape)
        # no atomics: the split channel sum is added in a fixed order
        first = correlation(*args)
        if not torch.equal(first, correlation(*args)):
            raise AssertionError(f"correlation {shape}: two launches disagree")
        del args, first
    for shape in [CORR_TRAIN_SHAPE] + CORR_SHAPES + CORR_EDGE_SHAPES + CORR_BWD_EDGE_SHAPES:
        # the backward: each element summed by one thread in a fixed order
        args = corr_bwd_case(shape, gen)
        record("correlation_bwd", torch.float32,
               compare("correlation_bwd", args, torch.float32), shape)
        first = correlation_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(first, correlation_bwd(*args))):
            raise AssertionError(f"correlation_bwd {shape}: two launches disagree")
        del args, first
    for name, shape, dtype in BWD_CHECKS:
        args = bwd_case(name, shape, dtype, gen)
        record(name, dtype, compare(name, args, dtype), shape)
        del args
    for dtype in (torch.float32, torch.bfloat16):
        for shapes in CONV7_SHAPES.values():
            for _, ci, co, h, w in shapes:
                args = conv7_case(ci, co, h, w, dtype, gen)
                record("conv7", dtype, compare("conv7", args, dtype), (ci, co, h, w))
        # the VALID entry on a pre-padded input (the Pallas contract)
        x, wt, bias = conv7_case(80, 3, 512, 512, dtype, gen)
        xp = F.pad(x, (3, 3, 3, 3), mode="reflect")
        record("conv7", dtype, compare("conv7", (xp, wt, bias), dtype, conv7_padded,
                                       conv7_plain), ("padded", 80, 3, 512, 512))
        for c, h, w, _ in RESPAIR_SHAPES:
            plain_args, relu_args, res_args = conv3_cases(c, h, w, dtype, gen)
            record("conv3", dtype, compare("conv3", plain_args, dtype), (c, h, w))
            for form, args in (("relu", relu_args), ("residual", res_args)):
                record("conv3_fused", dtype, compare("conv3_fused", args, dtype),
                       (form, c, h, w))
        del args, plain_args, relu_args, res_args, x, xp
    check_f32_bodies(gen, errs)
    return errs


def warp_forward_checks(gen: torch.Generator, dtype, record) -> None:
    """Phase 3, the warp forwards' two paths at their path shapes: on a
    smooth flow against the plain version (`record`), then on both flow
    kinds under the plan, under the staged tile (tile_plan: 32 KB), the
    direct tile (no budget) and the staged tile with the largest budget:
    the four outputs bit for bit, and each launch's staged tiles equal to
    staged_tiles's count."""
    cases = [("warp_blend", (1, 3, h, w)) for h, w in WARP_SHAPES]
    cases.append(("flow_warp", FLOW_WARP_SHAPE))
    for name, (b, c, h, w) in cases:
        for kind in WARP_FLOWS:
            if name == "warp_blend":
                raw, prev, flow, weight = args = warp_case(h, w, dtype, gen, b, c, kind)
            else:
                prev, flow = args = flow_warp_case(dtype, gen, (b, c, h, w), kind)
                raw = weight = None
            if kind == "smooth":
                record(name, dtype, compare(name, args, dtype), (c, h, w), flow=kind)
            plan = warp_forward_plan(c, dtype, h, w, w)
            tile = tile_plan(dtype, staged=True)
            outs, counts = [], []
            for p in (plan, tile, tile_plan(dtype, staged=False),
                      tile._replace(smem_bytes=MAX_BOX_BYTES)):
                staged = torch.zeros(1, dtype=torch.int32, device=DEV)
                outs.append(warp_forward_cuda(prev, flow, raw, weight, -1, p, staged))
                counts.append((int(staged), staged_tiles(flow, p, c)))
            tiles = b * math.ceil(h / tile.rows) * math.ceil(w / tile.cols)
            if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                raise AssertionError(f"{name} {(b, c, h, w)} {dtype} {kind}: the staged "
                                     "and the direct paths disagree")
            if any(k != m for k, m in counts) or counts[2][0] != 0:
                raise AssertionError(f"{name} {(b, c, h, w)} {dtype} {kind}: staged tiles "
                                     f"(kernel, staged_tiles) {counts}")
            say("check", kernel=name, check="staged_vs_direct", flow=kind,
                shape="x".join(map(str, (b, c, h, w))), dtype=str(dtype)[6:],
                plan=f"{plan.rows}x{plan.cols}x{plan.pix}/{plan.smem_bytes}",
                plan_staged=counts[0][0],
                staged_tile=f"{tile.rows}x{tile.cols}x{tile.pix}/{tile.smem_bytes}",
                tiles=tiles, staged=counts[1][0], staged_at_226KB=counts[3][0],
                bit_for_bit=True, ok=True)
            del args, prev, flow, raw, weight, outs


def check_f32_bodies(gen: torch.Generator, errs: dict) -> None:
    """Phase 3, the f32 convs of the single-image paths against the plain
    version in f32 with TF32 off, under TOL: respair at RESPAIR_F32_SHAPES
    (the tensor cores, its only body) and conv7 at CONV7_SHAPES on each body
    forced in turn, one line per shape. Every tensor-core result must also
    be within F32_TENSOR_CORE_ERR. The err of the body the rule picks goes
    into errs, the other's into OTHER_BODY_ERRS."""
    cases = [("respair", (c, h, w), path) for c, h, w, _, path in RESPAIR_F32_SHAPES]
    cases += [("conv7", (ci, co, h, w), path)
              for path, shapes in CONV7_SHAPES.items() for _, ci, co, h, w in shapes]
    for name, shape, path in cases:
        if name == "respair":
            args = respair_case(*shape, torch.float32, gen)
            got = {"tensor_cores": compare(name, args, torch.float32)}
            picked = "tensor_cores"
        else:
            args = conv7_case(*shape, torch.float32, gen)
            got = {}
            for body, code in BODIES.items():
                with forced_conv7_body(code):
                    got[body] = compare(name, args, torch.float32)
            picked = rule_name(conv7_body(torch.float32, *shape[:2]))
            other = next(b for b in BODIES if b != picked)
            OTHER_BODY_ERRS[name] = max(OTHER_BODY_ERRS.get(name, 0.0), got[other])
        errs[name][torch.float32] = max(errs[name].get(torch.float32, 0.0), got[picked])
        tol = TOL[(name, torch.float32)]
        say("check_f32_bodies", kernel=name, path=path, shape="x".join(map(str, shape)),
            **{f"{body}_max_abs_err": f"{e:.3g}" for body, e in got.items()}, rule=picked,
            bound=f"{tol['atol']}+{tol['rtol']}*|plain|",
            tensor_cores_bound=F32_TENSOR_CORE_ERR, ok=True)
        if got["tensor_cores"] >= F32_TENSOR_CORE_ERR:
            raise AssertionError(
                f"{name} f32 {shape}: the 3xTF32 body is off the plain version by "
                f"{got['tensor_cores']:.3g} >= {F32_TENSOR_CORE_ERR} (f32-class products "
                "keep it near 2e-5)")
        del args


def wgmma_smem(f32: bool, k: int, bn: int, rw: int) -> int:
    """The dynamic shared memory of a KxK launch of the tensor-core body at
    tile (BN, RW) with four or more chunks, as csrc/conv_wgmma.cuh::rings
    sizes it: the barriers, the operand ring (or the epilogue tile, if
    larger) and the staging ring, shortened to fit 227 KB (the staging ring
    to two slots, the operand ring to two stages, the staging ring to one,
    the operand ring to one, with two staging slots again where they fit).
    A chunk is 16 bf16 channels, or 8 f32 channels in two tf32 parts."""
    parts = 2 if f32 else 1
    th, hr = 2 * rw, 2 * rw + k - 1
    stage = parts * (2 * hr * 80 * 16 + 2 * k * k * bn * 16)
    stg, out = hr * 16 * 88 * 2, bn * (th * 64 + 4) * 4
    n_stages = n_stg = 4

    def total():
        return 128 + max(n_stages * stage, out) + n_stg * stg
    while total() > 232448 and n_stages > 1:
        if n_stg > 2:
            n_stg -= 1
        elif n_stages > 2:
            n_stages -= 1
        elif n_stg > 1:
            n_stg -= 1
        else:
            n_stages -= 1
    if n_stages == 1 and n_stg == 1:
        n_stg = 2
        if total() > 232448:
            n_stg = 1
    return total()


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output."""
    report, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return report


def sass_counts(lib_path, opcode: str) -> dict:
    """{mangled kernel name: count of the opcode in its SASS}, from
    cuobjdump -sass of the built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def correlation_build_line(regs: dict, kernel: str, smem: int, threads: int,
                           blocks_per_sm: int) -> None:
    """Phase 2: a correlation kernel's registers, spills and shared memory,
    and the blocks an SM holds by each (registers and spills: None where
    the library was already built); raises on spills, or if fewer than
    `blocks_per_sm` fit (ops/correlation.py's TILE_BLOCKS_PER_SM and
    BWD_BLOCKS_PER_SM: the plans' waves assume them)."""
    # no report where the library was built by an earlier run in this checkout
    name = next((n for n in regs if f"{len(kernel)}{kernel}E" in n), None)
    r, st, ld = regs[name] if name else (None, None, None)
    by_regs = 65536 // (threads * -(-r // 8) * 8) if name else None
    by_smem = 233472 // (smem + 1024)  # 228 KB an SM, 1 KB reserved a block
    say("build_kernel", kernel=kernel, registers=r, spill_store_bytes=st,
        spill_load_bytes=ld, dyn_smem_bytes=smem, threads=threads,
        blocks_per_sm_by_registers=by_regs, blocks_per_sm_by_smem=by_smem)
    fit = by_smem if by_regs is None else min(by_regs, by_smem)
    if st or ld or fit < blocks_per_sm:
        raise AssertionError(f"build: {name} spills ({st}, {ld}) or fits fewer than "
                             f"{blocks_per_sm} blocks an SM ({by_regs}, {by_smem})")


def warp_build_lines(regs: dict) -> None:
    """Phase 2: each instantiation of the warp forward (csrc/warp_blend.cu::
    warp_kernel<T, BLEND, VEC, STAGED>): registers, spills, its own shared
    memory, and under its tile (tile_plan: the staged one with a box budget
    of 32 KB, the direct one with none) its threads and blocks an SM by
    registers and by shared memory (None where the library was built by an
    earlier run)."""
    pattern = r"warp_kernelI(f|13__nv_bfloat16)Lb(\d)ELb(\d)ELb(\d)E"
    found = sorted((m.groups(), n) for n in regs if (m := re.search(pattern, n)))
    if not found:
        say("build_kernel", kernel="warp_kernel", registers=None)
    for (t, blend, vec, staged), name in found:
        dtype = torch.float32 if t == "f" else torch.bfloat16
        plan = tile_plan(dtype, staged=staged == "1")
        threads = plan_threads(plan)
        own = 16 if plan.smem_bytes else 0  # the staged kernel's box limits
        r, st, ld = regs[name]
        say("build_kernel", kernel=f"warp_kernel<{str(dtype)[6:]}, blend={blend == '1'}, "
            f"vec={vec == '1'}, staged={staged == '1'}>", pix=plan.pix, registers=r,
            spill_store_bytes=st, spill_load_bytes=ld, static_smem_bytes=own,
            plan=f"{plan.rows}x{plan.cols}", threads=threads, dyn_smem_bytes=plan.smem_bytes,
            blocks_per_sm_by_registers=65536 // (threads * -(-r // 8) * 8) if threads else None,
            blocks_per_sm_by_smem=233472 // (plan.smem_bytes + own + 1024))


def build_phase() -> None:
    """Phase 2: build the kernels; one line per kernel of the tensor-core
    body (csrc/conv_wgmma.cuh: bf16 and f32 as 3xTF32, K = 3 and 7) with its
    registers, spills, shared memory and HGMMA count. Raises unless every
    one, in both element types, holds HGMMA and spills nothing, or if a 3x3
    instantiation of the CUDA-core body (conv_kxk.cuh) is left."""
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path = build.build(verbose=True)
    build.library()
    seconds = time.perf_counter() - t0
    print(log.getvalue(), end="")
    regs = ptxas_report(log.getvalue())
    hgmma = sass_counts(lib_path, "HGMMA")
    wgmma = sorted(n for n in hgmma if "conv_wgmma_kernel" in n)
    pattern = r"conv_wgmma_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELi(\d+)E"
    kinds = {}
    for name in wgmma:
        f32, k, bn, rw, reflect, cl = (int(v) for v in re.search(pattern, name).groups())
        kinds[(f32, k)] = kinds.get((f32, k), 0) + 1
        r, st, ld = regs.get(name, (None, None, None))
        say("build_kernel", kernel=f"conv_wgmma_kernel<{bool(f32)}, {k}, {bn}, {rw}, "
            f"{bool(reflect)}, {cl}>", dtype="float32 (3xTF32)" if f32 else "bfloat16",
            registers=r, spill_store_bytes=st, spill_load_bytes=ld,
            dyn_smem_bytes=wgmma_smem(bool(f32), k, bn, rw), hgmma=hgmma[name])
        if hgmma[name] == 0 or st or ld:
            raise AssertionError(f"build: {name} holds no HGMMA or spills ({st}, {ld})")
    for f32, k in ((0, 3), (0, 7), (1, 3), (1, 7)):
        if not kinds.get((f32, k)):
            raise AssertionError(f"build: no {'f32' if f32 else 'bf16'} {k}x{k} "
                                 "conv_wgmma_kernel in the library")
    old = [n for n in hgmma if "conv3x3_kernel" in n]
    if old:
        raise AssertionError(f"build: CUDA-core 3x3 kernels remain: {old}")
    warp_build_lines(regs)
    correlation_build_line(regs, "correlation_kernel", TILE_SMEM_BYTES, TILE_THREADS,
                           TILE_BLOCKS_PER_SM)
    correlation_build_line(regs, "correlation_bwd_kernel", BWD_SMEM_BYTES, BWD_THREADS,
                           BWD_BLOCKS_PER_SM)
    say("build", seconds=f"{seconds:.2f}", lib=lib_path.name, wgmma_kernels=len(wgmma),
        wgmma_7x7_kernels=kinds[(0, 7)] + kinds[(1, 7)],
        f32_wgmma_kernels=kinds[(1, 3)] + kinds[(1, 7)],
        hgmma_total=sum(hgmma[n] for n in wgmma))


def reference_generator() -> None:
    """Phase 4: the small label2city generator, card (kernels) vs CPU
    (plain), f32; its 7x7 stems and heads run conv7 on the card."""
    opt_s = Options(**SMALL)
    h_s, w_s = 64, 256
    labels, inst = label_stream(opt_s, 3, h_s, w_s)
    engines = {d: seeded_engine(opt_s, d, seed=1) for d in ("cpu", DEV)}
    frames = {}
    reset_launches()
    for d, eng in engines.items():
        state = eng.initial_state(1, h_s, w_s)
        outs = []
        for t in range(3):
            f, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
            outs.append(f.cpu())
        frames[d] = torch.stack(outs, 1)
    launches = read_launches()
    small_err = float((frames[DEV] - frames["cpu"]).abs().max())
    if not small_err <= 2e-3:
        raise AssertionError(f"small reference: card vs CPU max abs err {small_err}")
    if not launches["conv7"] > 0:
        raise AssertionError(f"small reference: conv7 never launched {launches}")
    say("reference", config="small 64x256 f32", frames=3,
        max_abs_err=f"{small_err:.3g}", bound=2e-3,
        launches=json.dumps({k: v for k, v in launches.items() if v}), ok=True)


def reference_flow() -> None:
    """Phase 4b: FlowEstimator on one (B=1, T=2) pair stack at 96x160 (the
    //64 resize round trip): card vs CPU, same weights, f32; the bounds of
    tests/test_flownet2_oracle.py:406-410. PyTorch's default TF32 flags:
    the estimator turns cuDNN's TF32 off itself."""
    im1, im2 = frame_pairs(2, 96, 160, seed=1)
    outs, tf32_seen = {}, []
    for d in ("cpu", DEV):
        est = seeded_flow_estimator(d, seed=1, tf32_seen=tf32_seen)
        with torch_default_tf32():
            outs[d] = [t.cpu() for t in est(im1.to(d), im2.to(d))]
            check_f32_convs(tf32_seen)
    flow_err = float((outs[DEV][0] - outs["cpu"][0]).abs().max())
    conf_ok = float(((outs[DEV][1] - outs["cpu"][1]).abs() < 1e-3).float().mean())
    if not (flow_err <= 2e-3 and conf_ok >= 0.99):
        raise AssertionError(
            f"FlowEstimator reference: flow max abs err {flow_err} (bound 2e-3), "
            f"conf share within 1e-3 {conf_ok} (bound 0.99)")
    say("reference", config="FlowEstimator 96x160 (1, 2) f32",
        flow_max_abs_err=f"{flow_err:.3g}", flow_bound=2e-3,
        conf_share_within_1e3=f"{conf_ok:.5f}", conf_bound=0.99,
        flow_abs_max=f"{float(outs['cpu'][0].abs().max()):.3g}",
        conf_mean=f"{float(outs['cpu'][1].mean()):.4g}", ok=True)


def reference_training() -> None:
    """Phase 4c: two training chunks of a small configuration at 128x64,
    f32: the card (kernels, forward and backward) against the CPU (plain),
    each chunk from the same weights (see train_reference) and the same
    clip, PyTorch's default TF32 flags (the training steps turn cuDNN's
    TF32 off themselves); the bounds of tests/test_train_oracle.py."""
    reset_launches()
    with torch_default_tf32():
        ref_losses = train_reference(2)
    ref_launches = read_launches()
    bad = out_of_bounds(ref_losses[DEV], ref_losses["cpu"])
    if bad:
        raise AssertionError("training reference, card vs CPU: " + "; ".join(bad))
    for name in ("warp_blend", "flow_warp", "warp_blend_bwd", "flow_warp_bwd"):
        if ref_launches[name] == 0:
            raise AssertionError(f"training reference: {name} never launched")
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-3)
                for g, w in zip(ref_losses[DEV], ref_losses["cpu"])
                for k in TRAIN_KEYS + GRAD_KEYS)
    say("reference", config="training 128x64 ngf16 f32, 2 chunks", ok=True,
        max_rel_err=f"{worst:.3g}", bounds="losses 2e-4/2e-2 grad norms 5e-3/5e-2",
        loss_G_total=",".join(f"{c['loss_G_total']:.6g}" for c in ref_losses["cpu"]),
        launches=json.dumps({k: v for k, v in ref_launches.items() if v}))


def face_inputs(t: int, h: int, w: int, n_parts: int, n_images: int, seed: int):
    """(edge maps (1, t, 15, H, W), real frames (1, 2, 3, H, W), part maps
    (1, 2, H, W), training clusters) from numpy: blocky part maps of ids
    0..n_parts-1 (0 has no clusters), n_images cluster rows of 16 features
    + a count per part. The published features.npy is not in the repo."""
    rng = np.random.default_rng(seed)
    edges = rng.uniform(-1, 1, (1, t, 15, h, w)).astype(np.float32)
    real = rng.uniform(-1, 1, (1, 2, 3, h, w)).astype(np.float32)
    parts = rng.integers(0, n_parts, (1, 2, h // 16, w // 16))
    parts = np.kron(parts, np.ones((16, 16), np.int64))
    clusters = {p: rng.standard_normal((n_images, 17)).astype(np.float32)
                for p in range(1, n_parts)}
    return (*(torch.from_numpy(a) for a in (edges, real, parts)), clusters)


def reference_single_g() -> None:
    """Phase 4d: single-image seeding of both registries at small widths,
    card (kernels) vs CPU (plain), f32: a small LocalEnhancer in place of
    the label2city 2048 registry's on a 64x128 label stream, and the
    edge2face registry's GlobalWithFeatures + Encoder at small dims
    (sg_cfg) with the face-feature lookup over seeded clusters at 64x64.
    PyTorch's default TF32 flags: the engine turns cuDNN's TF32 off for
    the nets itself."""
    city = Options(**SMALL, dataroot="datasets/Cityscapes/", loadSize=2048,
                   use_single_G=True)
    face = Options(**EDGE2FACE | dict(ngf=8, n_downsample_G=2, n_blocks=1, bf16=False))
    face_cfg = {"feat_num": 4, "g": dict(ngf=8, nd=2, nb=2, norm="instance"),
                "e": dict(out_nc=4, ngf=8, nd=2, norm="instance")}
    labels, inst = label_stream(city, 1, 64, 128)
    edges, real, parts, clusters = face_inputs(2, 64, 64, 5, 10, seed=1)
    clusters = {p: c[:, :5] for p, c in clusters.items()}  # 4 features + 1
    states, tf32_seen = {}, []
    reset_launches()
    with torch_default_tf32():
        for d in ("cpu", DEV):
            eng = InferenceEngine(city, device=d)
            if not isinstance(eng.build_single_g(), LocalEnhancer):
                raise AssertionError("label2city 2048 registry: not a LocalEnhancer")
            eng.single_g = LocalEnhancer(4, ngf=8, n_downsample_global=2, n_blocks_global=2,
                                         n_blocks_local=1).to(d).eval()
            seed_net(eng.single_g, 11)
            watch_tf32(tf32_seen, eng.single_g)
            enc = eng.encode(labels[:, :2], inst[:, :2])
            states[("city", d)] = [t.cpu() for t in eng.single_g_first_frames(enc)]
            eng = InferenceEngine(face, device=d)
            eng.build_single_g(face_cfg)
            seed_net(eng.single_g, 12)
            seed_net(eng.encoder, 13)
            watch_tf32(tf32_seen, eng.single_g, eng.encoder)
            states[("face", d)] = [t.cpu() for t in eng.single_g_first_frames(
                edges, real, parts, clusters)]
        check_f32_convs(tf32_seen, "the single-image nets")
    launches = read_launches()
    errs = {}
    for reg in ("city", "face"):
        got, want = states[(reg, DEV)], states[(reg, "cpu")]
        errs[reg] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not errs[reg] <= 5e-4 or not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"single-image reference {reg}: card vs CPU {errs[reg]}")
    if launches["conv7"] != 2 * (3 + 4) or launches["respair"] != 2 * (3 + 2):
        raise AssertionError(f"single-image reference launches {launches}")
    say("reference", config="single-image seeding f32: LocalEnhancer ngf8 64x128, "
        "GlobalWithFeatures ngf8 + Encoder 64x64", city_max_abs_err=f"{errs['city']:.3g}",
        face_max_abs_err=f"{errs['face']:.3g}", bound=5e-4,
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        net_cudnn_allow_tf32=sorted(set(tf32_seen)), ok=True)


def flow_pairs(b: int, h: int, w: int, seed: int = 0):
    """(B, 2, H, W, 3) frame pairs and (B, H, W, 2) flows from numpy: the
    second frame is the first moved 3 px right and 2 down, plus small noise,
    and the flow is (3, 2) everywhere."""
    rng = np.random.default_rng(seed)
    first = rng.random((b, h, w, 3), dtype=np.float32)
    moved = np.roll(first, (2, 3), axis=(1, 2))
    moved += 0.02 * rng.standard_normal(moved.shape, dtype=np.float32)
    pair = np.stack([first, np.clip(moved, 0.0, 1.0)], 1)
    return pair, np.broadcast_to(np.float32([3.0, 2.0]), (b, h, w, 2)).copy()


def seeded_flownet_c(seed: int) -> FlowNetC:
    """FlowNetC with its training outputs and the reference flow nets'
    initialisation from a seeded torch.Generator (on the CPU)."""
    net = FlowNetC(train_outputs=True)
    init_flownet_weights(net, torch.Generator().manual_seed(seed))
    return net


def reference_flow_train() -> None:
    """Phase 4e: one f32 FlowNetC training step (FlowHarness.train_step) at
    (1, 2, 64, 128, 3): the card (both correlation kernels) against the CPU
    (plain), same weights and inputs, PyTorch's default TF32 flags (the
    harness turns cuDNN's TF32 off itself). Bounds: loss and EPE 1e-4
    relative, each parameter's gradient 1e-3 relative in L2: f32 sums in
    other orders (cuDNN's algorithms, the kernels'), through ~20 layers."""
    pair, flow = flow_pairs(1, 64, 128, seed=1)
    got, tf32_seen = {}, []
    reset_launches()
    for d in ("cpu", DEV):
        net = seeded_flownet_c(seed=1)
        watch_tf32(tf32_seen, net)
        harness = FlowHarness(net, device=d)
        with torch_default_tf32():
            loss, err = harness.train_step(pair, flow)
            check_f32_convs(tf32_seen, "FlowNetC training")
        got[d] = (float(loss), float(err),
                  {n: p.grad.cpu() for n, p in harness.net.named_parameters()})
    launches = read_launches()
    (loss_c, err_c, g_c), (loss_d, err_d, g_d) = got["cpu"], got[DEV]
    rel = {n: float((g_d[n] - g_c[n]).norm() / g_c[n].norm()) for n in g_c}
    worst = max(rel, key=rel.get)
    if not (math.isclose(loss_d, loss_c, rel_tol=1e-4) and math.isclose(err_d, err_c, rel_tol=1e-4)
            and rel[worst] <= 1e-3):
        raise AssertionError(f"FlowNetC training reference: loss {loss_d} vs {loss_c}, EPE "
                             f"{err_d} vs {err_c}, gradient {worst} off by {rel[worst]:.3g}")
    if launches["correlation"] != 1 or launches["correlation_bwd"] != 1:
        raise AssertionError(f"FlowNetC training reference launches {launches}")
    say("reference", config="FlowNetC training step (1, 2, 64, 128, 3) f32", loss=f"{loss_d:.6g}",
        loss_rel_err=f"{abs(loss_d - loss_c) / abs(loss_c):.3g}", epe=f"{err_d:.6g}",
        epe_rel_err=f"{abs(err_d - err_c) / abs(err_c):.3g}", bound=1e-4,
        grad_worst=worst, grad_worst_rel_l2=f"{rel[worst]:.3g}", grad_bound=1e-3,
        launches=json.dumps({k: v for k, v in launches.items() if v}), ok=True)


def label2city_path(card: str) -> dict:
    """Phase 5: the label2city path at full width; returns the kernels'
    launch counts on it."""
    opt = Options(**FLAGSHIP)
    h, w, n_frames, warm = 1024, 2048, 8, 2
    t0 = time.perf_counter()
    eng = seeded_engine(opt, DEV, seed=0)
    labels, inst = label_stream(opt, n_frames, h, w)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = eng.initial_state(1, h, w)
    torch.cuda.reset_peak_memory_stats()
    times, fakes = [], []
    reset_launches()
    for t in range(n_frames):
        t1 = time.perf_counter()
        fake, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state,
                               use_raw_only=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        fakes.append(fake)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for fake in fakes:
        if fake.shape != (1, 3, h, w) or fake.dtype != torch.float32:
            raise AssertionError(f"frame {tuple(fake.shape)} {fake.dtype}")
        if not torch.isfinite(fake).all():
            raise AssertionError("non-finite frame")
        if float(fake.abs().max()) > 1 + 1e-2:
            raise AssertionError(f"|fake| {float(fake.abs().max())} > 1 + 1e-2")
    want = dict.fromkeys(KERNELS, 0) | {
        "respair": 45 * n_frames, "warp_blend": 3 * n_frames, "conv7": 21 * n_frames}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    t = n_frames - 1

    def frame():
        return eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state, use_raw_only=False)

    profile = profile_by_family(frame, "one label2city 2048x1024 frame",
                                out_path("chip_smoke_profile_label2city.txt"), DEV)
    say("main_path", config="label2city 2048x1024 3-scale ngf128 fg bf16",
        frames=n_frames, setup_s=f"{setup_s:.1f}",
        ms_per_frame_median=f"{statistics.median(times[warm:]):.2f}",
        ms_per_frame=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        card=repr(card))
    say_profile("main_path_profile", profile)
    trace_frame(frame, profile)
    zero = eng.initial_state(1, h, w)
    conv7_route_ab(eng, frame, lambda: eng.step(labels[:, :3], inst[:, :3], zero)[0])
    return launches


def trace_frame(frame, profile, tries: int = 3) -> None:
    """Phase 5: one frame under utils/profiling.py::trace, its Chrome trace
    under build/trace_label2city, summed by family (summarize_trace); each
    of our families' ms must agree with profile_by_family's table of another
    frame within 5% or 5 us (the warps' three calls are ~50 us in all, and a
    trace's timestamps are whole us). A window that disagrees is printed and
    recorded anew, as profile_by_family does, three windows at most."""
    ours = {f: ms for f, ms, _ in profile[0] if f.endswith("(ours)")}
    log_dir = out_path("trace_label2city")
    shutil.rmtree(log_dir, ignore_errors=True)
    for attempt in range(1, tries + 1):
        with trace(log_dir, DEV):
            frame()
            torch.cuda.synchronize()
        traced = dict(summarize_trace(log_dir))
        off = {f: (round(traced.get(f, 0.0), 4), round(ms, 4)) for f, ms in ours.items()
               if abs(traced.get(f, 0.0) - ms) > max(0.05 * ms, 0.005)}
        if not off:
            break
        say("trace_disagrees", window=attempt, trace_vs_profile=json.dumps(off))
    else:
        raise AssertionError(f"trace: our families' ms never matched the profile: {off}")
    say("main_path_trace", trace_dir=log_dir, window=attempt,
        families=json.dumps({f: round(ms, 4) for f, ms in traced.items()}),
        ours_vs_profile=json.dumps({f: [round(traced.get(f, 0.0), 4), round(ms, 4)]
                                    for f, ms in ours.items()}))


@contextlib.contextmanager
def conv7_on_cudnn(net: torch.nn.Module):
    """Within the block, every eval ReflectConv7 of `net` runs as before the
    composite was routed through conv7: ReflectionPad2d(3) + nn.Conv2d
    (cuDNN) in the module's dtype, on the kernel's own weight arguments
    (a tied norm folded in: nn/layers.py::FoldsNorm). For the A/B only;
    nothing in the port selects it."""
    convs = [m for m in net.modules() if isinstance(m, ReflectConv7)]

    def on_cudnn(x, m):
        w, bias, _ = m.eval_weights(x, m._kernel_args)
        return F.conv2d(F.pad(x, (3, 3, 3, 3), mode="reflect"), w, bias.to(x.dtype))

    for m in convs:
        m.forward = lambda x, m=m: on_cudnn(x, m)
    try:
        yield len(convs)
    finally:
        for m in convs:
            del m.forward


def conv7_route_ab(eng, frame, first_frame, n: int = 5) -> None:
    """Phase 5, the A/B of the route: one label2city frame with the
    composite's 7x7 stems and heads on conv7 (the port's path) and on
    cuDNN, in turns cuDNN, conv7, conv7, cuDNN, n frames each after one
    warm-up frame; host clock around torch.cuda.synchronize(). The two
    sides' first frames from the zero state (in [-1, 1]) must agree within
    0.05 on average: bf16 rounding of the 7x7 convs, summed in another
    order, moves them by far less, a wrong conv by O(1). (A later frame
    warps the previous ones by 20 * 2**scale times a flow of seeded
    weights: a rounding there can move a sample across an edge, so its
    largest difference says little.)"""
    times = {"conv7": [], "cudnn": []}
    outs = {}
    for side in ("cudnn", "conv7", "conv7", "cudnn"):
        with (conv7_on_cudnn(eng.compute_generator()) if side == "cudnn"
              else contextlib.nullcontext()):
            outs[side] = first_frame()
            frame()
            torch.cuda.synchronize()
            for _ in range(n):
                t1 = time.perf_counter()
                frame()
                torch.cuda.synchronize()
                times[side].append((time.perf_counter() - t1) * 1e3)
    diff = (outs["conv7"] - outs["cudnn"]).abs()
    if not float(diff.mean()) <= 0.05:
        raise AssertionError(f"conv7 A/B: the two routes' first frames differ by "
                             f"{float(diff.mean())} on average")
    med = {side: statistics.median(v) for side, v in times.items()}
    say("conv7_route_ab", frames_per_side=2 * n, order="cudnn,conv7,conv7,cudnn",
        conv7_ms_median=f"{med['conv7']:.2f}", cudnn_ms_median=f"{med['cudnn']:.2f}",
        conv7_over_cudnn=f"{med['conv7'] / med['cudnn']:.4f}",
        conv7_ms=",".join(f"{v:.2f}" for v in times["conv7"]),
        cudnn_ms=",".join(f"{v:.2f}" for v in times["cudnn"]),
        first_frame_mean_abs_diff=f"{float(diff.mean()):.3g}",
        first_frame_max_abs_diff=f"{float(diff.max()):.3g}",
        route_wins=med["conv7"] < med["cudnn"])


def label2city_clip_path(card: str) -> dict:
    """Phase 5c: the flagship configuration of phase 5 streaming an 8-frame
    clip through InferenceEngine.generate_clip_raw, the labels on the host
    (one frame a step goes to the card). Checks every kernel's launch count
    in that run, holds its frames and state to the step loop's from the same
    seeded state within CLIP_TOL, times ms per frame of both in turns (step,
    clip, clip, step; each one 8-frame run after a warm-up of both; host
    clock around torch.cuda.synchronize()), and reads the peak memory of
    generate_clip_raw against encode + generate_clip on the same clip.
    Returns the launch counts of the counted clip."""
    opt = Options(**FLAGSHIP)
    (h, w), n_frames = CITY_HW, 8
    eng = seeded_engine(opt, DEV, seed=0)
    labels, inst = label_stream(opt, n_frames, h, w)
    zero = eng.initial_state(1, h, w)

    def clip():
        return eng.generate_clip_raw(labels, inst, zero)

    def steps():
        state, fakes = zero, []
        for t in range(n_frames):
            fake, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
            fakes.append(fake)
        return torch.stack(fakes, 1), state

    clip()
    steps()
    torch.cuda.synchronize()
    reset_launches()
    outs, clip_state = clip()
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(KERNELS, 0) | {
        "respair": 45 * n_frames, "warp_blend": 3 * n_frames, "conv7": 21 * n_frames}
    if launches != want:
        raise AssertionError(f"generate_clip_raw launch counts {launches}, want {want}")
    check_frames(outs.fake.unbind(1), (1, 3, h, w), "generate_clip_raw")
    if any(o.dtype != torch.float32 for o in outs) or any(
            s.dtype != torch.bfloat16 for s in clip_state):
        raise AssertionError("generate_clip_raw: outputs not f32 or state not bf16")
    ref, step_state = steps()
    diffs = []
    for got, ref_t in [(outs.fake, ref)] + list(zip(clip_state, step_state)):
        err = (got.float() - ref_t.float()).abs()
        if bool((err > CLIP_TOL["atol"] + CLIP_TOL["rtol"] * ref_t.float().abs()).any()):
            raise AssertionError(f"generate_clip_raw vs the step loop: max abs diff "
                                 f"{float(err.max())} outside {CLIP_TOL}")
        diffs.append(float(err.max()))
    del outs, clip_state, ref, step_state
    times = {"clip": [], "step": []}
    for side in ("step", "clip", "clip", "step"):
        t1 = time.perf_counter()
        (clip if side == "clip" else steps)()
        torch.cuda.synchronize()
        times[side].append((time.perf_counter() - t1) * 1e3 / n_frames)
    torch.cuda.empty_cache()
    resting = torch.cuda.memory_allocated()
    peaks = {}
    for name, run in (("generate_clip_raw", clip),
                      ("encode_generate_clip",
                       lambda: eng.generate_clip(eng.encode(labels, inst), zero))):
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    say("clip_path", config="label2city 2048x1024 3-scale ngf128 fg bf16, generate_clip_raw",
        frames=n_frames, launches=json.dumps({k: v for k, v in launches.items() if v}),
        frames_max_abs_diff_vs_step=f"{diffs[0]:.3g}",
        state_max_abs_diff_vs_step=f"{max(diffs[1:]):.3g}", bound=CLIP_TOL,
        clip_ms_per_frame=",".join(f"{v:.2f}" for v in times["clip"]),
        step_ms_per_frame=",".join(f"{v:.2f}" for v in times["step"]),
        clip_over_step=f"{statistics.mean(times['clip']) / statistics.mean(times['step']):.4f}",
        order="step,clip,clip,step", resting_gib=f"{resting / 2**30:.3f}",
        peak_gib_generate_clip_raw=f"{peaks['generate_clip_raw'] / 2**30:.3f}",
        peak_gib_encode_generate_clip=f"{peaks['encode_generate_clip'] / 2**30:.3f}",
        card=repr(card))
    return launches


def flownet2_path(card: str) -> dict:
    """Phase 5b: the FlowNet2 path at full width, FlowEstimator in f32 on
    (1, 2) pairs of 1024x2048 frames under PyTorch's default TF32 flags, as
    in 4b; returns the kernels' launch counts on it."""
    h, w, n_calls, warm = 1024, 2048, 4, 1
    t0 = time.perf_counter()
    tf32_seen = []
    est = seeded_flow_estimator(DEV, seed=0, tf32_seen=tf32_seen)
    im1, im2 = (t.to(DEV) for t in frame_pairs(2, h, w, seed=0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, results = [], []
    with torch_default_tf32():
        for _ in range(n_calls):
            t1 = time.perf_counter()
            flow, conf = est(im1, im2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            results.append((flow, conf))
        check_f32_convs(tf32_seen)
        caller_tf32 = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for flow, conf in results:
        if flow.shape != (1, 2, 2, h, w) or conf.shape != (1, 2, 1, h, w):
            raise AssertionError(f"flow {tuple(flow.shape)}, conf {tuple(conf.shape)}")
        if not (torch.isfinite(flow).all() and torch.isfinite(conf).all()):
            raise AssertionError("non-finite flow or confidence")
        if float(conf.min()) < 0.0 or float(conf.max()) > 1.0:
            raise AssertionError("confidence outside [0, 1]")
    want = dict.fromkeys(KERNELS, 0) | {"flow_warp": 5 * n_calls, "correlation": n_calls}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    med = statistics.median(times[warm:])
    flow = results[-1][0]
    say("flownet2_path", config="FlowEstimator FlowNet2 1024x2048 (B=1, T=2) f32",
        calls=n_calls, setup_s=f"{setup_s:.1f}",
        ms_per_call_median=f"{med:.2f}", ms_per_pair_median=f"{med / 2:.2f}",
        ms_per_call=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        flow_abs_max=f"{float(flow.abs().max()):.4g}",
        flow_abs_mean=f"{float(flow.abs().mean()):.4g}",
        conf_mean=f"{float(results[-1][1].mean()):.4g}",
        caller_cudnn_allow_tf32=caller_tf32[0], caller_matmul_allow_tf32=caller_tf32[1],
        net_cudnn_allow_tf32=tf32_seen[0], card=repr(card))
    return launches


def training_path(card: str) -> dict:
    """Phase 7: the training path at the 512x256 recipe's full width: one
    warm-up clip, then timed clips of three chunks (two frames each), and
    one chunk under the profiler; the reference flow is the ported
    FlowEstimator with seeded weights. Returns the kernels' launch counts
    over the timed clips."""
    opt = Options(**TRAIN_RECIPE)
    h, w, n_timed = 256, 512, 3
    t0 = time.perf_counter()
    est = seeded_flow_estimator(DEV, seed=3, tf32_seen=[])
    trainer = Trainer(opt, flow_fn=est)  # the card: the default device
    state = trainer.init_state()
    labels, frames = moving_square_clip(np.random.default_rng(0), 8, h, w, 35)
    labels, frames = torch.from_numpy(labels).to(DEV), torch.from_numpy(frames).to(DEV)
    before = {k: v.detach().clone() for k, v in
              list(trainer.gen.named_parameters()) + list(trainer.engine.netD.named_parameters())}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    chunk_ms = []
    chunk_fn = trainer.train_chunk

    def timed_chunk(*args, **kwargs):
        t1 = time.perf_counter()
        result = chunk_fn(*args, **kwargs)  # reads the losses back: a sync
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
        return result

    trainer.train_chunk = timed_chunk
    with torch_default_tf32():
        t1 = time.perf_counter()
        state, losses = trainer.train_clip(state, labels, frames, labels)
        warm_s = time.perf_counter() - t1
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        chunk_ms.clear()
        t1 = time.perf_counter()
        clip_losses = []
        for _ in range(n_timed):
            state, losses = trainer.train_clip(state, labels, frames, labels)
            clip_losses.append(losses)
        clip_s = (time.perf_counter() - t1) / n_timed
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        # one more clip's middle chunk under the profiler
        carry = trainer.start_clip()
        state, carry, _ = chunk_fn(state, carry, labels[:, :4], frames[:, :4], labels[:, :4])
        families, busy_ms, prof_wall = profile_by_family(
            lambda: chunk_fn(state, carry, labels[:, 2:6], frames[:, 2:6], labels[:, 2:6]),
            "one training chunk", out_path("chip_smoke_profile.txt"), DEV)
    n_chunks = len(chunk_ms)
    if n_chunks != 3 * n_timed:
        raise AssertionError(f"{n_chunks} chunks in {n_timed} clips, want {3 * n_timed}")
    for losses in clip_losses:
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite training loss {losses}")
    moved = {k for k, v in list(trainer.gen.named_parameters())
             + list(trainer.engine.netD.named_parameters()) if not torch.equal(v, before[k])}
    if not any(k.startswith("G0.") for k in moved) or not any("scale" in k for k in moved):
        raise AssertionError("the generator's or the discriminator's weights did not change")
    for name in ("warp_blend", "warp_blend_bwd", "flow_warp", "flow_warp_bwd", "correlation"):
        if launches[name] == 0:
            raise AssertionError(f"training path: {name} never launched "
                                 f"({launches})")
    med = statistics.median(chunk_ms)
    say("train_path", config="label2city 512x256 ngf128 fg bf16 remat, FlowNet2 f32",
        clips=n_timed, chunks=n_chunks, setup_s=f"{setup_s:.1f}",
        warmup_clip_s=f"{warm_s:.2f}", ms_per_chunk_median=f"{med:.2f}",
        train_it_per_s=f"{1e3 / med:.3f}", clip_it_per_s=f"{3 / clip_s:.3f}",
        ms_per_chunk=",".join(f"{v:.1f}" for v in chunk_ms),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        loss_G_total=",".join(f"{c['loss_G_total']:.5g}" for c in clip_losses),
        loss_D_total=",".join(f"{c['loss_D_total']:.5g}" for c in clip_losses),
        params_changed=len(moved), card=repr(card))
    say("train_profile", profiled_chunk_wall_ms=f"{prof_wall:.2f}",
        kernel_ms=f"{busy_ms:.2f}", busy_share_of_median_chunk=f"{busy_ms / med:.3f}",
        families=json.dumps({f: [round(ms, 3), n] for f, ms, n in families}))
    return launches


def export_path(card: str) -> dict:
    """Phase 10: the serving artifact of the flagship configuration
    (tools/export.py): exported on the card from seeded weights, saved,
    loaded into a fresh step, and 4 frames streamed through it and through
    InferenceEngine.step in turns from the same zero state. The artifact
    runs the same kernels on the same bf16 values in the same order, so its
    frames and state must equal the engine's within CLIP_TOL (bit for bit
    expected); each artifact frame must launch respair 45, conv7 21 and
    warp_blend 3 times and nothing else. Returns the launch counts of the
    artifact's frames."""
    opt = Options(**FLAGSHIP)
    (h, w), n_frames = CITY_HW, 4
    eng = seeded_engine(opt, DEV, seed=0)
    labels, inst = label_stream(opt, n_frames, h, w)
    out = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        program = export.save_exported(out, opt, eng, 1, h, w)
        torch.cuda.synchronize()
        export_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(out, f)) for f in export.FILES)
        t0 = time.perf_counter()
        step = export.load_exported(out, DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    nodes = collections.Counter(str(n.target) for n in program.graph.nodes
                                if n.op == "call_function")
    del program
    per_frame = {"respair": 45, "conv7": 21, "warp_blend": 3}
    ops = {f"v2v.{k}.default": v for k, v in per_frame.items()}
    if {k: v for k, v in nodes.items() if k.startswith("v2v.")} != ops:
        raise AssertionError(f"exported graph: operator nodes {dict(nodes)}, want {ops}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state_a, state_e = None, eng.initial_state(1, h, w)
    launches, diffs = dict.fromkeys(KERNELS, 0), []
    for t in range(n_frames):
        windows = labels[:, t : t + 3], inst[:, t : t + 3]
        before = read_launches()
        frame_a, state_a = step(*windows, state_a)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in read_launches().items()}
        if got != dict.fromkeys(KERNELS, 0) | per_frame:
            raise AssertionError(f"artifact frame {t}: launches {got}, want {per_frame}")
        launches = {k: launches[k] + got[k] for k in launches}
        frame_e, state_e = eng.step(*windows, state_e)
        check_frames(frame_a, (3, h, w), "artifact")
        if any(a.dtype != e.dtype for a, e in zip(state_a, state_e)):
            raise AssertionError("artifact: state dtypes differ from the engine's")
        for got_t, ref_t in [(frame_a, frame_e)] + list(zip(state_a, state_e)):
            err = (got_t.float() - ref_t.float()).abs()
            if bool((err > CLIP_TOL["atol"] + CLIP_TOL["rtol"] * ref_t.float().abs()).any()):
                raise AssertionError(f"artifact frame {t} vs eng.step: max abs diff "
                                     f"{float(err.max())} outside {CLIP_TOL}")
            diffs.append(float(err.max()))
    peak = torch.cuda.max_memory_allocated()
    # ms a frame in turns (step, artifact, artifact, step; 5 frames each after
    # one warm-up frame; host clock around torch.cuda.synchronize()), the
    # windows on the host as a server receives them; then both with the
    # windows already on the card, which leaves out their copy
    windows = labels[:, :3], inst[:, :3]
    on_card = tuple(x.to(DEV) for x in windows)
    sides = {"step": lambda: eng.step(*windows, state_e),
             "artifact": lambda: step(*windows, state_a),
             "step_windows_on_card": lambda: eng.step(*on_card, state_e),
             "artifact_windows_on_card": lambda: step(*on_card, state_a)}
    times = {name: [] for name in sides}
    for name in ("step", "artifact", "artifact", "step", "step_windows_on_card",
                 "artifact_windows_on_card", "artifact_windows_on_card",
                 "step_windows_on_card"):
        sides[name]()
        torch.cuda.synchronize()
        for _ in range(5):
            t1 = time.perf_counter()
            sides[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t1) * 1e3)
    # the device's work is the same kernels; under the profiler the graph
    # module's host time is not the artifact's (it records every node)
    for name in ("artifact", "step"):
        say_profile(f"export_profile_{name}", profile_by_family(
            sides[name], f"one {name} frame",
            out_path(f"chip_smoke_profile_export_{name}.txt"), DEV))
    say("export_path", config="label2city 2048x1024 3-scale ngf128 fg bf16, tools/export.py",
        frames=n_frames, export_s=f"{export_s:.2f}", load_s=f"{load_s:.2f}",
        artifact_bytes=nbytes, graph_nodes=sum(nodes.values()),
        graph_nodes_not_ours=sum(v for k, v in nodes.items() if not k.startswith("v2v.")),
        launches_per_frame=json.dumps(per_frame), max_abs_diff_vs_step=f"{max(diffs):.3g}",
        bit_for_bit=max(diffs) == 0.0, bound=CLIP_TOL,
        **{f"{k}_ms_median": f"{statistics.median(v):.2f}" for k, v in times.items()},
        **{f"{k}_ms": ",".join(f"{x:.2f}" for x in v) for k, v in times.items()},
        order="step,artifact,artifact,step, then the same on the card's windows",
        peak_gib=f"{peak / 2**30:.3f}", card=repr(card))
    return launches


def ledger_path(card: str) -> dict:
    """Phase 11: tools/train_ledger.py at the 512x256 recipe on the card
    (3 timed clips of the serialized split): its table and JSON line. Every
    step's FLOPs must be positive with a bound; the G step, which trains
    plain layers, launches no respair or conv7; the flow forward launches
    one correlation a chunk. Returns the launch counts of the whole run."""
    reset_launches()
    ledger = train_ledger.main(["--reps", "3"])
    launches = read_launches()
    for name in (*train_ledger.STEPS, train_ledger.FLOW_ROW):
        row = ledger[name]
        if not (row["tflop_per_iter"] > 0 and row["bound_ms"] and row["frac_of_bound"]):
            raise AssertionError(f"ledger row {name}: {row}")
    g = ledger["g_step"]["launches_per_iter"]
    if g.get("respair", 0) or g.get("conv7", 0):
        raise AssertionError(f"ledger: the G step launched respair or conv7: {g}")
    corr = ledger[train_ledger.FLOW_ROW]["launches_per_iter"].get("correlation")
    if corr != 1.0:
        raise AssertionError(f"ledger: {corr} correlation launches a chunk, want 1")
    say("ledger_path", config=ledger["config"], iters=ledger["iters"],
        steady_ms_per_iter=f"{ledger['steady_ms_per_iter']:.2f}",
        serialized_ms_per_iter=f"{ledger['serialized_ms_per_iter']:.2f}", card=repr(card))
    return launches


def ddp_clip() -> tuple[np.ndarray, np.ndarray]:
    """The global batch of phase 12: PoseClips' two clips at POSE_DDP
    (clip 0 with DensePose's face parts, clip 1 without), stacked: labels
    (2, T, 6, H, W), frames (2, T, 3, H, W), T = 2 DDP_LOAD + tG - 1."""
    opt = Options(**POSE_DDP)
    clips = PoseClips(opt, POSE_DDP_RAW_HW)
    items = [clips[i] for i in range(2)]
    t = 2 * DDP_LOAD + opt.n_frames_G - 1
    if items[0]["A"].shape[0] < t:
        raise AssertionError(f"pose clip of {items[0]['A'].shape[0]} frames, want {t}")
    return tuple(np.stack([it[k][:t] for it in items]) for k in ("A", "B"))


def ddp_trainer(n_devices: int, batch: int, device):
    """The phase-12 Trainer (POSE_DDP at --n_devices / --batchSize) with the
    training phase's seeded FlowEstimator, and its state."""
    opt = Options(**POSE_DDP).replace(n_devices=n_devices, batchSize=batch)
    trainer = Trainer(opt, flow_fn=seeded_flow_estimator(device, seed=3, tf32_seen=[]),
                      device=device)
    return trainer, trainer.init_state()


def map_tensors(obj, fn):
    """`obj` with fn applied to every tensor in it (nested lists, tuples and
    dataclass fields, as a ClipCarry holds them)."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: map_tensors(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    return obj


def save_state_after_first(path: str | None):
    """run_chunks' after_chunk: after chunk 0, the generator's and the
    engine's weights and the clip's carry saved to `path`."""
    def after(k, trainer, carry):
        if path is not None and k == 0:
            torch.save({"gen": trainer.gen.state_dict(), "engine": trainer.engine.state_dict(),
                        "carry": map_tensors(carry, lambda t: t.cpu())}, path)
    return after


def displacement_then_load(path: str | None, init: dict, stats: dict):
    """run_chunks' after_chunk for a rank: after chunk 0, this rank's
    weight displacement from `init` (its weights before chunk 0, by name)
    against the single process's (its weights saved at `path` by
    save_state_after_first, from the same init) into `stats`: the relative
    L2 of the difference and the share of the moved weights that moved the
    same way; then the weights from `path` and this rank's rows of its
    carry take the place of the rank's own (its Adam moments stay)."""
    def after(k, trainer, carry):
        if path is None or k != 0:
            return None
        saved = torch.load(path, map_location="cpu", weights_only=False)
        diff_sq = ref_sq = agree = moved = 0.0
        for part, module in (("gen", trainer.gen), ("engine", trainer.engine)):
            for name, p in module.named_parameters():
                w0 = init[f"{part}.{name}"].to(p.device)
                d_rank = p.detach() - w0
                d_one = saved[part][name].to(p.device) - w0
                diff_sq += float(((d_rank - d_one) ** 2).sum())
                ref_sq += float((d_one ** 2).sum())
                agree += float(((torch.sign(d_rank) == torch.sign(d_one)) & (d_one != 0)).sum())
                moved += float((d_one != 0).sum())
        stats.update(rel_l2=math.sqrt(diff_sq / ref_sq), same_direction=agree / moved,
                     moved=int(moved))
        trainer.gen.load_state_dict(saved["gen"])
        trainer.engine.load_state_dict(saved["engine"])
        return map_tensors(saved["carry"], lambda t: trainer.local_rows(t).to(trainer.device))
    return after


def time_gradient_reduces(buckets, group, dev: torch.device) -> list[tuple[float, int]]:
    """(ms between two synchronizes, bucket bytes) of one all_reduce_mean
    over `group` of a bucket the size of each list of parameters in
    `buckets` (as train/steps.py::_apply reduces a step's gradients), the
    ranks started together by a barrier; nothing without a group."""
    out = []
    if mesh.group_size(group) == 1:
        return out
    for params in buckets:
        grads = [torch.zeros_like(p) for p in params]
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mesh.all_reduce_mean(grads, group)
        torch.cuda.synchronize(dev)
        out.append(((time.perf_counter() - t0) * 1e3, 4 * sum(g.numel() for g in grads)))
        del grads
    return out


def ddp_rank(labels: np.ndarray, frames: np.ndarray, device: str,
             state_path: str | None) -> dict:
    """One rank of phase 12, in a process started by parallel.launch (this
    script imported anew as its main module): the rank's Trainer on the
    global clip (it keeps its rows), under kernel_call_shapes; the launch
    counts, the calls' shapes, the peak memory, the warnings of ops that
    have no deterministic algorithm (it runs under
    workers.deterministic_algorithms), run_chunks' losses, weights digests
    and ms a chunk, and afterwards each gradient bucket's all-reduce
    (time_gradient_reduces); with `state_path`, the chunk-1 displacement
    against the single process's and chunk 2 from the weights and (this
    rank's rows of) the carry saved there (displacement_then_load)."""
    world = torch.distributed.get_world_size()
    torch.distributed.barrier()  # one collective on the backend, whatever the world
    dev = torch.device(device)
    trainer, state = ddp_trainer(world, labels.shape[0], dev)
    init = {f"{part}.{name}": p.detach().to("cpu", copy=True)
            for part, module in (("gen", trainer.gen), ("engine", trainer.engine))
            for name, p in module.named_parameters()} if state_path else {}
    displacement = {}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    with torch_default_tf32(), kernel_call_shapes() as seen, \
            warnings.catch_warnings(record=True) as caught, \
            deterministic_algorithms():
        warnings.simplefilter("always")
        out = run_chunks(trainer, state, torch.from_numpy(labels), torch.from_numpy(frames),
                         None, DDP_LOAD,
                         after_chunk=displacement_then_load(state_path, init, displacement))
    torch.cuda.synchronize(dev)
    launches, peak = read_launches(), torch.cuda.max_memory_allocated(dev)
    del init
    index = {id(fn): i for fns in COUNTERS.values() for i, fn in enumerate(fns)}
    out.update(
        launches=launches, peak=peak, displacement=displacement,
        reduces=time_gradient_reduces(
            [[p for pg in opt.param_groups for p in pg["params"]]
             for opt in (state.opt_g, state.opt_d, *state.opt_dt)], trainer.group, dev),
        nondeterministic=sorted({str(w.message)[:120] for w in caught
                                 if "deterministic" in str(w.message)}),
        seen=[(name, index[id(fn)], shapes, str(dtype), calls)
              for (name, fn, shapes, dtype), calls in seen.items()])
    return out


def ddp_reference(labels: np.ndarray, frames: np.ndarray,
                  state_path: str | None = None) -> dict:
    """Phase 12's single-process Trainer (no group) on the card, under
    workers.deterministic_algorithms: run_chunks' losses, weights digests
    and ms a chunk; with `state_path`, its weights and carry after chunk 1
    are saved there."""
    trainer, state = ddp_trainer(1, labels.shape[0], DEV)
    with torch_default_tf32(), \
            deterministic_algorithms():
        out = run_chunks(trainer, state, torch.from_numpy(labels), torch.from_numpy(frames),
                         None, DDP_LOAD, after_chunk=save_state_after_first(state_path))
    del trainer, state
    torch.cuda.empty_cache()
    return out


def ddp_train_path(card: str, seen: dict) -> dict:
    """Phase 12: the data axis (parallel/, --n_devices 2) at the pose2body
    256p recipe's width through parallel.launch:
      - world 1 over NCCL (rank 0 on this card, batch 1): its losses and
        weights after each chunk equal the plain Trainer's bit for bit
        (every training here runs under deterministic algorithms);
      - world 2 over gloo on this one card (NCCL refuses two ranks on one
        device; gloo all-reduces the CUDA tensors through host memory),
        batch 2, one sample a rank: the two ranks' weights equal bit for
        bit after every chunk, and the losses within the training bounds
        (out_of_bounds) of the single-process Trainer at batch 2.
    Chunk 2 of the two ranks restarts from the single process's state after
    chunk 1, weights and carry (as train_reference does between the CPU
    and the card with the weights); their own Adam moments stay. So the
    losses of chunk 2 are a second one-step comparison, and the trajectory
    is held by chunk 1's weight displacement instead: its relative L2
    against the single process's within DDP_DISPLACEMENT_REL_L2.
    The ranks' kernel calls join `seen` (phase 3b checks their shapes);
    returns the launch counts summed over every rank of both runs. Two
    ranks sharing one card give no scaling figure."""
    t0 = time.perf_counter()
    labels, frames = ddp_clip()
    clip_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        # every run is under deterministic algorithms: without them the
        # plain Trainer differs from itself (chunk 2's G grad norm by ~2%
        # from one saved state). Chunk 2 of the two ranks starts from the
        # single process's state after chunk 1 (weights and carry): Adam's
        # first step moves each weight by ~lr whatever its gradient's size,
        # so gradients near zero whose sign the order of a sum flips set
        # the weights apart by ~2 lr (chunk 2's D_T losses then differed by
        # ~2.5%)
        first = os.path.join(tmp, "after_chunk1.pt")
        ref1 = ddp_reference(labels[:1], frames[:1])
        ref2 = ddp_reference(labels, frames, state_path=first)
        runs = {}
        for name, world, backend, lab, frm, path in (
                ("nccl_world1", 1, "nccl", labels[:1], frames[:1], None),
                ("gloo_world2", 2, "gloo", labels, frames, first)):
            t1 = time.perf_counter()
            runs[name] = launch(ddp_rank, world, args=(lab, frm, str(DEV), path),
                                devices=[DEV] * world, backend=backend,
                                deadline_s=DDP_DEADLINE_S)
            runs[name + "_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (one,), two = runs["nccl_world1"], runs["gloo_world2"]
    if one["losses"] != ref1["losses"] or one["digests"] != ref1["digests"]:
        raise AssertionError(
            f"ddp_train: world 1 over NCCL differs from the plain Trainer: losses "
            f"{[c['loss_G_total'] for c in one['losses']]} vs "
            f"{[c['loss_G_total'] for c in ref1['losses']]}, digests {one['digests']} vs "
            f"{ref1['digests']}")
    if two[0]["digests"] != two[1]["digests"] or len(two[0]["digests"]) != 2:
        raise AssertionError(f"ddp_train: the ranks' weights differ: {two[0]['digests']} vs "
                             f"{two[1]['digests']}")
    bad = out_of_bounds(two[0]["losses"], ref2["losses"])
    if bad:
        raise AssertionError(f"ddp_train: 2 ranks vs one process at batch 2: {bad}")
    displacement = [r["displacement"] for r in two]
    if displacement[0] != displacement[1] or not (
            displacement[0]["rel_l2"] <= DDP_DISPLACEMENT_REL_L2):
        raise AssertionError(
            f"ddp_train: the ranks' chunk-1 weight displacement against one process's: "
            f"{displacement} (relative L2 limit {DDP_DISPLACEMENT_REL_L2})")
    launches = collections.Counter()
    for rank in [one, *two]:
        for name in ("warp_blend", "warp_blend_bwd", "flow_warp", "flow_warp_bwd",
                     "correlation"):
            if rank["launches"][name] == 0:
                raise AssertionError(f"ddp_train: a rank never launched {name}")
        launches.update(rank["launches"])
        for name, i, shapes, dtype, calls in rank["seen"]:
            key = (name, COUNTERS[name][i], shapes, getattr(torch, dtype.split(".")[1]))
            seen[key] = seen.get(key, 0) + calls
    reduces = [r["reduces"] for r in two]
    say("ddp_train_path", config="pose2body 256p (recipes/pose/train_256p.sh) ngf128 f32, "
        "FlowNet2 f32, 2 chunks of 6 frames of 256x192; cut: batchSize 2 on --n_devices 2 "
        "(recipe 8 on 8), one clip of 2 chunks (recipe n_frames_total 12); the 2 ranks' "
        "chunk 2 restarts from the single process's weights and carry after chunk 1 "
        "(their Adam moments kept), so its losses are a one-step comparison and chunk 1's "
        "weight displacement holds the trajectory",
        clip_build_s=f"{clip_s:.2f}", world1_nccl_s=f"{runs['nccl_world1_s']:.2f}",
        world2_gloo_s=f"{runs['gloo_world2_s']:.2f}",
        ms_per_chunk_world1=",".join(f"{v:.1f}" for v in one["ms"]),
        ms_per_chunk_rank0=",".join(f"{v:.1f}" for v in two[0]["ms"]),
        ms_per_chunk_rank1=",".join(f"{v:.1f}" for v in two[1]["ms"]),
        ms_per_chunk_one_process_b1=",".join(f"{v:.1f}" for v in ref1["ms"]),
        ms_per_chunk_one_process_b2=",".join(f"{v:.1f}" for v in ref2["ms"]),
        allreduce_ms_rank0=",".join(f"{ms:.1f}" for ms, _ in reduces[0]),
        allreduce_ms_rank1=",".join(f"{ms:.1f}" for ms, _ in reduces[1]),
        bucket_bytes=",".join(str(b) for _, b in reduces[0]),
        allreduce_buckets="G, D, D_T per scale: one all_reduce_mean each after the run, "
        "the ranks started by a barrier",
        chunk1_displacement_rel_l2=f"{displacement[0]['rel_l2']:.6g}",
        chunk1_displacement_same_direction=f"{displacement[0]['same_direction']:.6g}",
        chunk1_weights_moved=displacement[0]["moved"],
        displacement_rel_l2_limit=DDP_DISPLACEMENT_REL_L2,
        peak_mem_gib_world1=f"{one['peak'] / 2**30:.3f}",
        peak_mem_gib_ranks=",".join(f"{r['peak'] / 2**30:.3f}" for r in two),
        world1_bit_for_bit=True, ranks_equal_bit_for_bit=True,
        without_deterministic_algorithms=json.dumps(
            sorted({w for r in [one, *two] for w in r["nondeterministic"]})),
        loss_G_total=",".join(f"{c['loss_G_total']:.6g}" for c in two[0]["losses"]),
        loss_G_total_one_process=",".join(f"{c['loss_G_total']:.6g}" for c in ref2["losses"]),
        G_grad_norm=",".join(f"{c['G_grad_norm']:.6g}" for c in two[0]["losses"]),
        G_grad_norm_one_process=",".join(f"{c['G_grad_norm']:.6g}" for c in ref2["losses"]),
        launches=json.dumps(dict(launches)), scaling="none: two ranks share one card",
        card=repr(card))
    return {name: launches[name] for name in COUNTERS}


# ------------------------------------------------- 13. the model axis (serving)

# phase 13: the flagship served on SHARD_RANKS gloo ranks on this one card
SHARD_RANKS, SHARD_FRAMES, SHARD_DEADLINE_S = 2, 3, 600.0
# the uneven run of phase 13: the flagship at 1024x1440 on the same ranks,
# a clip through generate_clip_raw; its coarsest trunk's 45 columns split
# 22 / 23 (level SHARD_UNEVEN_TRUNK: 3 pyramid levels, 3 downsamples)
SHARD_UNEVEN_HW, SHARD_UNEVEN_FRAMES, SHARD_UNEVEN_TRUNK = (1024, 1440), 3, 5
# a flagship frame's launches, on every rank, all in the column-halo modes
SHARD_PER_FRAME = {"respair": 45, "conv7": 21, "warp_blend": 3}
# the sharded engine's frames against the unsharded engine's from the same
# seed: the kernels' column-halo modes are bit for bit with their unsharded
# calls, but cuDNN picks its own algorithms for the narrower down and up
# convs, so the frames may differ by bf16 rounding in another order, as
# generate_clip_raw's against the step loop's: one bf16 ulp of a frame
SHARD_TOL = CLIP_TOL
# the shapes at which a column-halo mode is held bit for bit to the
# unsharded call on the whole tensor, split over n shards, and to its plain
# version, and both timed: (shape, n). Flagship shapes on SHARD_RANKS:
# respair (C, H, W) at the coarsest trunk and an enhancer's; conv7 (Ci,
# Co, H, W) at the coarsest scale's label stem and the finest scale's
# image head; warp_blend (H, W) at the finest scale. Then the uneven ones:
# the coarsest trunk of a 1440-wide frame (45 columns: 22 / 23, odd local
# widths), and 1-column shards on 8, whose halos span two ranks (respair's
# 2) or three (conv7's 3) and whose edge shards reflect into their
# neighbours' columns
HALO_SHAPES = {"respair": [((1024, 32, 64), 2), ((64, 512, 1024), 2), ((1024, 32, 45), 2),
                           ((1024, 32, 8), 8)],
               "conv7": [((108, 128, 256, 512), 2), ((32, 3, 1024, 2048), 2),
                         ((128, 3, 64, 45), 2), ((128, 3, 64, 8), 8)],
               "warp_blend": [((1024, 2048), 2), ((64, 45), 2), ((64, 8), 8)]}
# the column-halo modes' times (halo_kernel_checks), for the kernels' JSON
HALO_MS: dict = {}
HALO_WRAPPERS = {"respair": respair_halo, "conv7": conv7_halo, "warp_blend": warp_blend_at}


def whole_strips(x: torch.Tensor, sh: halo.WidthShard, left: int, right: int):
    """What halo.exchange gives shard `sh` of x: its strips of the whole x
    reflect-padded, None on a side that is the image's edge."""
    p = max(left, right)
    xp = F.pad(x, (p, p, 0, 0), mode="reflect")
    x0, x1 = sh.x0 + p, sh.x1 + p
    lstrip = None if sh.left_edge else xp[..., x0 - left : x0]
    rstrip = None if sh.right_edge else xp[..., x1 : x1 + right]
    return lstrip, rstrip


def halo_calls(name: str, shape, n: int, gen) -> tuple:
    """(the unsharded call, [(shard, its column-halo wrapper, its args)] for
    each shard with columns) of a kernel at `shape` in bf16 on n shards,
    over seeded operands."""
    shards = [sh for sh in (halo.make_shard(i, n, shape[-1]) for i in range(n)) if sh.width]
    if name == "respair":
        c, h, w = shape
        x, k0, ab0, k1, ab1 = respair_case(c, h, w, torch.bfloat16, gen)
        packed = (pack_for_kernel(k0), pack_for_kernel(k1))
        calls = []
        for sh in shards:
            xl = sh.local(x).contiguous()
            x_in, xoff = halo.attach(xl, *whole_strips(x, sh, 2, 2))
            calls.append((sh, functools.partial(respair_halo, packed=packed),
                          (xl, x_in, xoff, sh.edges, k0, ab0, k1, ab1)))
        return functools.partial(respair, x, k0, ab0, k1, ab1, packed=packed), calls
    if name == "conv7":
        ci, co, h, w = shape
        x, wt, bias = conv7_case(ci, co, h, w, torch.bfloat16, gen)
        packed = pack_for_kernel(wt)
        calls = []
        for sh in shards:
            x_in, xoff = halo.attach(sh.local(x).contiguous(), *whole_strips(x, sh, 3, 3))
            calls.append((sh, functools.partial(conv7_halo, packed=packed),
                          (x_in, wt, bias, xoff, sh.width, sh.edges)))
        return functools.partial(conv7_reflect, x, wt, bias, packed=packed), calls
    h, w = shape
    raw, prev, flow, weight = warp_case(h, w, torch.bfloat16, gen)
    calls = [(sh, warp_blend_at, (sh.local(raw).contiguous(), prev, sh.local(flow).contiguous(),
                                  sh.local(weight).contiguous(), sh.x0)) for sh in shards]
    return functools.partial(warp_blend, raw, prev, flow, weight), calls


def halo_kernel_checks(gen: torch.Generator) -> None:
    """Phase 13: at each HALO_SHAPES shape, each shard's column-halo call
    against the unsharded call on the whole tensor, bit for bit, and
    against its plain version (compare, the kernel's TOL; raises
    otherwise), and the ms of both (CUDA events, time_ms), into HALO_MS."""
    for name, cases in HALO_SHAPES.items():
        for shape, n in cases:
            whole, calls = halo_calls(name, shape, n, gen)
            want = whole()
            err = 0.0
            for sh, fn, args in calls:
                if not torch.equal(fn(*args), sh.local(want)):
                    raise AssertionError(f"{name} {shape} on {n}: shard {sh.index}'s column-halo "
                                         "call differs from the unsharded call")
                wrapper = HALO_WRAPPERS[name]
                err = max(err, compare(name, args, torch.bfloat16, wrapper, PLAIN_OF[wrapper]))
            ms_whole = time_ms(lambda: whole(), ())
            ms_shards = [time_ms(fn, args) for _, fn, args in calls]
            HALO_MS.setdefault(name, []).append(
                {"shape": list(shape), "shards": n, "ms_unsharded": ms_whole,
                 "ms_shards": ms_shards})
            say("halo_mode", kernel=name, shape="x".join(map(str, shape)), dtype="bfloat16",
                shards=n, widths=",".join(str(sh.width) for sh, _, _ in calls),
                bit_for_bit_with_unsharded=True, max_abs_err_vs_plain=f"{err:.3g}",
                ms_unsharded=f"{ms_whole:.4f}",
                ms_shards=",".join(f"{v:.4f}" for v in ms_shards),
                shards_over_unsharded=f"{sum(ms_shards) / ms_whole:.4f}")
            del want, calls, whole
    torch.cuda.empty_cache()


def time_halo_collectives(shard: halo.WidthShard, dev: torch.device, n: int = 20) -> dict:
    """Phase 13, after the runs: the ms of one halo exchange of a rank's
    strips at the flagship's coarsest respair (C 1024, 32 rows, 2 + 2
    columns) and finest label stem (C 108, 1024 rows, 3 + 3 columns), and of
    one gather of a finest frame's columns, each the mean of n calls
    between a barrier and a synchronize (bf16)."""
    cases = {"exchange_respair_1024x32": (1024, 5, 2),
             "exchange_conv7_108x1024": (108, 0, 3),
             "gather_frame_3x1024": (3, 0, 0)}
    out = {}
    for name, (c, level, h) in cases.items():
        sh = shard.at(level)
        x = torch.zeros((1, c, shard.height0 >> level, sh.width), device=dev,
                        dtype=torch.bfloat16)
        call = ((lambda: halo.exchange(x, sh, h, h)) if h
                else (lambda: halo.gather_width(x, sh)))
        call()
        torch.distributed.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) * 1e3 / n
    return out


def counted_run(run, dev, index: dict) -> dict:
    """One run of a phase-13 rank with the launch counts and the model
    axis's collectives from zero, its kernel calls logged by shape; the
    frames in bf16, which they are before their cast to f32."""
    reset_launches()
    halo.reset_counts()
    with kernel_call_shapes() as seen:
        frames = run()
        torch.cuda.synchronize(dev)
    return dict(frames=frames.to("cpu", torch.bfloat16), launches=read_launches(),
                halo_launches={k: fn.launches for k, fn in HALO_WRAPPERS.items()},
                counts=dict(halo.COUNTS),
                seen=[(name, index[id(fn)], shapes, str(dtype), calls)
                      for (name, fn, shapes, dtype), calls in seen.items()])


def shard_rank(labels: np.ndarray, inst: np.ndarray, device: str, uneven: tuple) -> dict:
    """One rank of phase 13, in a process started by parallel.launch (this
    script imported anew): the flagship InferenceEngine with --n_devices
    the world, rank 0's generator seeded as the parent's and the others'
    otherwise (the engine broadcasts rank 0's). After a warm-up of both
    entry points, one counted run of each (counted_run), then both timed
    in turns (clip, steps, steps, clip) with the peak memory; then one
    counted clip of the `uneven` (labels, inst) at SHARD_UNEVEN_HW."""
    dist = torch.distributed
    dist.barrier()
    dev = torch.device(device)
    world = dist.get_world_size()
    eng = InferenceEngine(Options(**FLAGSHIP, n_devices=world), device=dev)
    seed_net(eng.gen, 0 if dist.get_rank() == 0 else 1)
    labels, inst = torch.from_numpy(labels), torch.from_numpy(inst)
    (h, w), tg = labels.shape[-2:], eng.opt.n_frames_G
    n = labels.shape[1] - tg + 1
    zero = eng.initial_state(1, h, w)

    def clip():
        return eng.generate_clip_raw(labels, inst, zero)[0].fake

    def steps():
        state, fakes = zero, []
        for t in range(n):
            fake, state = eng.step(labels[:, t : t + tg], inst[:, t : t + tg], state)
            fakes.append(fake)
        return torch.stack(fakes, 1)

    clip()
    steps()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    index = {id(fn): i for fns in COUNTERS.values() for i, fn in enumerate(fns)}
    out = {what: counted_run(run, dev, index) for what, run in (("clip", clip), ("steps", steps))}
    ms = {"clip": [], "steps": []}
    for what in ("clip", "steps", "steps", "clip"):
        t0 = time.perf_counter()
        (clip if what == "clip" else steps)()
        torch.cuda.synchronize(dev)
        ms[what].append((time.perf_counter() - t0) * 1e3 / n)
    out.update(ms=ms, peak=torch.cuda.max_memory_allocated(dev),
               columns=(eng.shard(w, h).x0, eng.shard(w, h).width),
               collective_ms=time_halo_collectives(eng.shard(w, h), dev))
    labels_u, inst_u = (torch.from_numpy(a) for a in uneven)
    hu, wu = labels_u.shape[-2:]
    zero_u = eng.initial_state(1, hu, wu)
    out["uneven"] = counted_run(
        lambda: eng.generate_clip_raw(labels_u, inst_u, zero_u)[0].fake, dev, index)
    sh = eng.shard(wu, hu)
    out["uneven"]["columns"] = [sh.bounds(sh.index), sh.at(SHARD_UNEVEN_TRUNK).bounds(sh.index)]
    return out


def shard_serve_path(card: str, seen: dict) -> dict:
    """Phase 13: the model axis for serving (parallel/halo.py,
    --n_devices 2 on InferenceEngine): the flagship configuration at its
    full 2048x1024 width on SHARD_RANKS ranks over gloo on this one card
    (NCCL refuses two ranks on one device), each on its 1024 columns of
    every frame, through generate_clip_raw and the step loop on a
    SHARD_FRAMES-frame clip:
      - each rank's whole frames within SHARD_TOL of the unsharded engine's
        from the same seed (run here first), and the ranks' frames equal
        bit for bit;
      - every respair, conv7 and warp_blend launch of the ranks' frames in
        its column-halo mode (45, 21 and 3 a frame a rank), their calls'
        shapes and columns sent back for 3b, and each mode bit for bit
        with the unsharded call on the whole tensor at HALO_SHAPES
        (halo_kernel_checks, with both timed);
      - ms a frame per rank of both entry points, the model axis's
        collectives and bytes a frame, peak memory per rank, and
        tools/shard_serve_bench.py's A / B / C at its own configuration
        (2 ranks on this card);
      - the uneven width: a SHARD_UNEVEN_FRAMES-frame clip at
        SHARD_UNEVEN_HW on the same ranks, whose coarsest trunk splits its
        45 columns 22 / 23, within SHARD_TOL of the unsharded engine, the
        ranks bit for bit, every launch in its column-halo mode, its
        calls' shapes sent back for 3b (the plain versions at the odd local
        widths).
    Two ranks share one card over gloo: the times measure correctness and
    host overhead, not scaling. Returns the launch counts of both ranks'
    counted clip runs, summed."""
    opt = Options(**FLAGSHIP)
    (h, w), n = CITY_HW, SHARD_FRAMES
    labels, inst = label_stream(opt, n, h, w)
    eng = seeded_engine(opt, DEV, seed=0)
    zero = eng.initial_state(1, h, w)
    want_clip = eng.generate_clip_raw(labels, inst, zero)[0].fake.cpu()
    state, fakes = zero, []
    for t in range(n):
        fake, state = eng.step(labels[:, t : t + 3], inst[:, t : t + 3], state)
        fakes.append(fake.cpu())
    want = {"clip": want_clip, "steps": torch.stack(fakes, 1)}
    hu, wu = SHARD_UNEVEN_HW
    labels_u, inst_u = label_stream(opt, SHARD_UNEVEN_FRAMES, hu, wu)
    want["uneven"] = eng.generate_clip_raw(labels_u, inst_u, eng.initial_state(1, hu, wu))[
        0].fake.cpu()
    del eng, zero, state, fakes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(shard_rank, SHARD_RANKS,
                   args=(labels.numpy(), inst.numpy(), str(DEV),
                         (labels_u.numpy(), inst_u.numpy())),
                   devices=[DEV] * SHARD_RANKS, backend="gloo", deadline_s=SHARD_DEADLINE_S)
    launch_s = time.perf_counter() - t0
    errs = {}
    for what in ("clip", "steps", "uneven"):
        first = ranks[0][what]["frames"]
        shape = (1, 3, hu, wu) if what == "uneven" else (1, 3, h, w)
        check_frames(first.float().unbind(1), shape, f"shard_serve {what}")
        for r in ranks[1:]:
            if not torch.equal(r[what]["frames"], first):
                raise AssertionError(f"shard_serve {what}: the ranks' frames differ")
        ref = want[what].float()
        err = (first.float() - ref).abs()
        if bool((err > SHARD_TOL["atol"] + SHARD_TOL["rtol"] * ref.abs()).any()):
            raise AssertionError(f"shard_serve {what}: max abs diff {float(err.max())} from the "
                                 f"unsharded engine, outside {SHARD_TOL}")
        errs[what] = float(err.max())
    launches = collections.Counter()
    per_frame = SHARD_PER_FRAME
    for rank in ranks:
        for what in ("clip", "steps", "uneven"):
            got, t = rank[what], SHARD_UNEVEN_FRAMES if what == "uneven" else n
            for name, k in per_frame.items():
                if got["halo_launches"][name] != k * t or got["launches"][name] != k * t:
                    raise AssertionError(
                        f"shard_serve {what}: {name} launched {got['launches'][name]} times, "
                        f"{got['halo_launches'][name]} in its column-halo mode; want {k * t} "
                        "all in it")
            for name, i, shapes, dtype, calls in got["seen"]:
                key = (name, COUNTERS[name][i], shapes, getattr(torch, dtype.split(".")[1]))
                seen[key] = seen.get(key, 0) + calls
        launches.update(rank["clip"]["launches"])
    halo_kernel_checks(torch.Generator().manual_seed(13))
    bench = shard_serve_bench.run(SHARD_RANKS, reps=5, device="cuda",
                                  ranks_per_card=SHARD_RANKS)
    if bench["mean_abs_delta"] >= 1e-4 or not bench["ranks_equal"]:
        raise AssertionError(f"shard_serve_bench: sharded vs single {bench}")
    counts = [{k: v / n for k, v in r["clip"]["counts"].items()} for r in ranks]
    say("shard_serve_path", config="label2city 2048x1024 3-scale ngf128 fg bf16 (the "
        f"flagship), --n_devices {SHARD_RANKS}: data 1 x model {SHARD_RANKS}, gloo ranks on "
        f"this one card, {n} frames", launch_s=f"{launch_s:.1f}",
        columns=json.dumps([r["columns"] for r in ranks]),
        frames_max_abs_diff_vs_unsharded_clip=f"{errs['clip']:.3g}",
        frames_max_abs_diff_vs_unsharded_steps=f"{errs['steps']:.3g}", bound=SHARD_TOL,
        uneven=f"{hu}x{wu}, {SHARD_UNEVEN_FRAMES} frames through generate_clip_raw",
        uneven_columns_finest_and_trunk=json.dumps([r["uneven"]["columns"] for r in ranks]),
        frames_max_abs_diff_vs_unsharded_uneven=f"{errs['uneven']:.3g}",
        uneven_launches_per_rank=json.dumps(ranks[0]["uneven"]["halo_launches"]),
        ranks_equal_bit_for_bit=True,
        clip_ms_per_frame_ranks=json.dumps([[round(v, 2) for v in r["ms"]["clip"]]
                                            for r in ranks]),
        step_ms_per_frame_ranks=json.dumps([[round(v, 2) for v in r["ms"]["steps"]]
                                            for r in ranks]),
        order="clip,steps,steps,clip",
        collectives_per_frame_ranks=json.dumps(counts),
        collective_ms_ranks=json.dumps([{k: round(v, 4) for k, v in r["collective_ms"].items()}
                                        for r in ranks]),
        peak_mem_gib_ranks=",".join(f"{r['peak'] / 2**30:.3f}" for r in ranks),
        halo_launches_per_rank=json.dumps(ranks[0]["clip"]["halo_launches"]),
        scaling="none: two ranks share one card over gloo", card=repr(card))
    say("shard_serve_bench", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in bench.items()},
        ranks_per_card=SHARD_RANKS, card=repr(card))
    return {name: launches[name] for name in COUNTERS}


# ------------------------------------------------- 14. the model axis (training)

# phase 14: the 512x256 training recipe of phase 7 (recipes/street/
# train_512.sh: batch 1 on 8 devices, data 1 x model 8) cut to
# SHARD_TRAIN_RANKS gloo ranks sharing this one card, data 1 x model 2, its
# widths not cut: each rank holds 256 of the 512 columns (32 of the 64 at
# the trunk). One clip of SHARD_TRAIN_FRAMES frames: 2 chunks of 2. The
# training bounds hold chunk 1 against the unsharded Trainer with the
# generator in f32 (chunks 2 and 3 run the recipe's bf16): in bf16 chunk 1
# read 1.8e-3 apart (D_fake) and the G grad norm 5.9e-3 (NVIDIA H100
# 80GB HBM3, 700 W): the ranks' half-width
# convs and their norms' f32 sums round to bf16 apart on a few elements a
# layer, and the random-init generator amplifies them, as it amplifies
# f32's on the CPU (tests/test_torch_shard_train.py holds a clip without
# norms bit for bit). The bf16 chunks are the recipe's path, timed.
SHARD_TRAIN_RANKS, SHARD_TRAIN_FRAMES, SHARD_TRAIN_DEADLINE_S = 2, 6, 900.0
# the uneven run of phase 14: the recipe at 256x520 on the same ranks, one
# f32 chunk (4 frames) held to the unsharded Trainer within the training
# bounds; its trunk's 65 columns split 32 / 33 (level 3: 3 downsamples)
SHARD_TRAIN_UNEVEN_HW, SHARD_TRAIN_UNEVEN_FRAMES, SHARD_TRAIN_UNEVEN_TRUNK = (256, 520), 4, 3
# (B, C, H, W) of the G step's blend a frame at the recipe's width: the
# offset mode's backward is held to its plain version and to the unsharded
# call there, in bf16 (the recipe's G) and f32
SHARD_BWD_SHAPE = (1, 3, 256, 512)
# the uneven shapes at which it is held so too, untimed: (shape, n), odd
# local widths (45: 22 / 23) and 1-column shards
SHARD_BWD_UNEVEN = [((1, 3, 64, 45), 2), ((1, 3, 64, 8), 8)]
# the offset mode's checks and times (shard_bwd_checks), for the kernels' JSON
SHARD_BWD: dict = {}
# (B, C, H, W) of the loss engine's unfused warps (F_Warp, G_Warp) a chunk
# at the recipe's width, B the chunk's 2 frames: flow_warp_at and its
# backward are held to their plain versions and to the unsharded entries
# there on SHARD_TRAIN_RANKS shards, and timed; untimed at SHARD_BWD_UNEVEN
SHARD_WARP_SHAPE = (2, 3, 256, 512)
# their checks and times (shard_warp_checks), by entry, for the kernels' JSON
SHARD_WARP: dict = {}


def shard_train_clip(hw=TRAIN_HW, frames: int = SHARD_TRAIN_FRAMES) -> tuple[np.ndarray,
                                                                               np.ndarray]:
    """Phase 7's clip: labels (1, T, H, W) (the instance map too) and
    frames (1, T, 3, H, W) of the moving square, T = `frames`."""
    return moving_square_clip(np.random.default_rng(0), frames, *hw, 35)


@contextlib.contextmanager
def step_peaks(trainer: Trainer, peaks: dict):
    """Within the block, each step of `trainer`'s bf16 chunks (its
    reference flow and train/loop.py's g_step, d_step and dt_step) records
    the peak device memory it reached into peaks[step] (the largest over
    the chunks), the peak statistics reset (after a synchronize) before
    each step. The steps' largest is the chunks' peak."""
    from vid2vid_tpu_torch.train import loop

    dev = trainer.device
    saved = {name: getattr(loop, name) for name in ("g_step", "d_step", "dt_step")}
    flow_fn = trainer.flow_fn

    def recorded(name, fn):
        def call(*args, **kwargs):
            if not trainer.opt.bf16:
                return fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated(dev))
            return out
        return call

    for name, fn in saved.items():
        setattr(loop, name, recorded(name, fn))
    trainer.flow_fn = recorded("flow", flow_fn)
    try:
        yield peaks
    finally:
        for name, fn in saved.items():
            setattr(loop, name, fn)
        trainer.flow_fn = flow_fn


@contextlib.contextmanager
def collective_times(dev: torch.device, times: dict):
    """Within the block, each torch.distributed all_reduce and all_gather
    is timed on the host between two synchronizes of `dev`, by the port's
    function that made it (the first frame of the stack outside torch,
    parallel/collectives.py and mesh.py's all_reduce_* helpers, as
    file.qualname; mesh._AllReduceSum is the norms' statistics, forward and
    backward, and steps._apply the gradients' bucket):
    times[caller] = [calls, ms in the collective, ms the synchronize before
    it waited for the card's queued work]. Over gloo a collective of CUDA
    tensors waits for that work anyway (it copies them to the host), so the
    synchronizes add little."""
    dist = torch.distributed
    saved = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}
    torch_dir = os.path.dirname(torch.__file__)

    def skipped(code) -> bool:
        name = code.co_filename
        return (name.startswith(torch_dir) or name.endswith(os.path.join("parallel",
                                                                          "collectives.py"))
                or name.endswith(os.path.join("parallel", "mesh.py"))
                and code.co_name.startswith("all_reduce_"))

    def timed(fn):
        def call(*args, **kwargs):
            frame = sys._getframe(1)
            while frame.f_back is not None and skipped(frame.f_code):
                frame = frame.f_back
            code = frame.f_code
            key = f"{os.path.basename(code.co_filename)[:-3]}.{code.co_qualname}"
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            row = times.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += (time.perf_counter() - t1) * 1e3
            row[2] += (t1 - t0) * 1e3
            return out
        return call

    for name, fn in saved.items():
        setattr(dist, name, timed(fn))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def shard_train_chunks(trainer: Trainer, labels, frames, on_bf16=None,
                       peaks: dict | None = None) -> dict:
    """run_chunks from fresh seeded weights (init_state) over the clip in
    chunks of the recipe's 2 frames (on every mesh: the schedule's
    n_frames_load grows with --n_devices), under deterministic algorithms
    and PyTorch's default TF32 flags: chunk 1 with the generator in f32
    (the training bounds' comparison), the later ones in the recipe's bf16
    (its path, timed and counted), `on_bf16(k)` called after each chunk
    k (run_chunks' after_chunk, once the next chunk's precision is set);
    with `peaks`, the bf16 chunks' peak memory by step (step_peaks)."""
    recipe = trainer.opt
    trainer.opt = recipe.replace(bf16=False)

    def after(k, tr, carry):
        tr.opt = recipe
        if on_bf16 is not None:
            on_bf16(k)

    labels, frames = torch.from_numpy(labels), torch.from_numpy(frames)
    state = trainer.init_state()
    try:
        with torch_default_tf32(), deterministic_algorithms(), (
                contextlib.nullcontext() if peaks is None else step_peaks(trainer, peaks)):
            return run_chunks(trainer, state, labels, frames, labels,
                              TRAIN_RECIPE["max_frames_per_gpu"], after_chunk=after)
    finally:
        trainer.opt = recipe


def shard_train_reference(trainer: Trainer, labels: np.ndarray, frames: np.ndarray) -> dict:
    """Phase 14's unsharded Trainer (one process, the card) over the clip
    (shard_train_chunks): run_chunks' losses, digests and ms a chunk, the
    peak memory of its bf16 chunks (by step, step_peaks) and the seconds
    it took."""
    t0 = time.perf_counter()
    peaks: dict = {}
    out = shard_train_chunks(trainer, labels, frames, peaks=peaks)
    out.update(peak=max(peaks.values(), default=0), step_peaks=peaks,
               seconds=time.perf_counter() - t0)
    return out


def shard_train_rank(labels: np.ndarray, frames: np.ndarray, device: str, root: str,
                     uneven: tuple) -> dict:
    """One rank of phase 14, in a process started by parallel.launch (this
    script imported anew): the recipe's Trainer with --n_devices the world
    at batch 1 (data 1 x model world), phase 7's seeded weights and flow,
    over the clip chunk by chunk (shard_train_chunks: chunk 1 in f32, the
    rest in bf16), its kernel calls logged by shape; the launch counts, the
    model axis's collectives a chunk, each chunk's collectives timed by
    caller (collective_times) and the peak memory of the bf16 chunks; the G
    gradients' reduction over every rank timed
    (time_gradient_reduces); then the `uneven` clip (labels, frames) at
    SHARD_TRAIN_UNEVEN_HW by a new Trainer (shard_train_chunks: its losses
    and digests, this rank's columns of the finest level and the trunk);
    then train_cli.train for one epoch of one SquareClips clip at the same
    options (the schedule's chunks of 2 x max_frames_per_gpu = 4 frames:
    one), `latest` written by rank 0 under `root`."""
    dist = torch.distributed
    dist.barrier()
    t0 = time.perf_counter()
    dev = torch.device(device)
    world = dist.get_world_size()
    est = seeded_flow_estimator(dev, seed=3, tf32_seen=[])
    trainer = Trainer(Options(**TRAIN_RECIPE, n_devices=world, batchSize=1), flow_fn=est,
                      device=dev)
    seconds = {"setup": time.perf_counter() - t0}
    counts, times, coll = [], [], {}
    # the launches of the unsharded entries FlowNet2 would make whole: none
    # on a rank (read before the counters restart, and at the end)
    unsharded = {"correlation": 0, "flow_warp": 0}

    def on_bf16(k):
        if k:
            counts.append(dict(halo.COUNTS))
        else:  # the bf16 chunks' launches and collectives from zero
            unsharded.update(correlation=correlation.launches, flow_warp=flow_warp.launches)
            reset_launches()
        halo.reset_counts()
        times.append(dict(coll))  # chunk k's collectives by caller
        coll.clear()

    index = {id(fn): i for fns in COUNTERS.values() for i, fn in enumerate(fns)}
    # the input widths that netD's finest layer saw: the rank's columns
    d_widths = set()
    getattr(trainer.engine.netD, f"scale{trainer.opt.num_D - 1}_layer0")[0] \
        .register_forward_pre_hook(lambda m, args: d_widths.add(args[0].shape[-1]))
    t1 = time.perf_counter()
    peaks: dict = {}
    with kernel_call_shapes() as seen, collective_times(dev, coll):
        out = shard_train_chunks(trainer, labels, frames, on_bf16, peaks)
        torch.cuda.synchronize(dev)
    seconds["chunks"] = time.perf_counter() - t1
    out.update(
        launches=read_launches(), counts=counts, collective_ms=times,
        offset_launches={"warp_blend_at": warp_blend_at.launches,
                         "warp_blend_at_bwd": warp_blend_at_bwd.launches,
                         "warp_blend": warp_blend.launches,
                         "warp_blend_bwd": warp_blend_bwd.launches,
                         "flow_warp_at": flow_warp_at.launches,
                         "flow_warp_at_bwd": flow_warp_at_bwd.launches,
                         "flow_warp_bwd": flow_warp_bwd.launches,
                         "flow_warp": flow_warp.launches,
                         "correlation": correlation.launches,
                         "correlation_halo": correlation_halo.launches},
        d_widths=sorted(d_widths),
        seen=[(name, index[id(fn)], shapes, str(dtype), calls)
              for (name, fn, shapes, dtype), calls in seen.items()],
        columns=(trainer.shard(*labels.shape[:-3:-1]).x0,
                 trainer.shard(*labels.shape[:-3:-1]).width),
        mesh=trainer.mesh.shape, peak=max(peaks.values(), default=0), step_peaks=peaks)
    (out["g_reduce_ms"], out["g_reduce_bytes"]), = time_gradient_reduces(
        [list(trainer.gen.parameters())], trainer.world_group, dev)
    del trainer
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    trainer = Trainer(Options(**TRAIN_RECIPE, n_devices=world, batchSize=1), flow_fn=est,
                      device=dev)
    labels_u, frames_u = uneven
    with kernel_call_shapes() as seen_u:
        out["uneven"] = shard_train_chunks(trainer, labels_u, frames_u)
        torch.cuda.synchronize(dev)
    sh = trainer.shard(*labels_u.shape[:-3:-1])
    out["uneven"].update(
        columns=[sh.bounds(sh.index), sh.at(SHARD_TRAIN_UNEVEN_TRUNK).bounds(sh.index)],
        seen=[(name, index[id(fn)], shapes, str(dtype), calls)
              for (name, fn, shapes, dtype), calls in seen_u.items()])
    seconds["uneven"] = time.perf_counter() - t1
    del trainer
    torch.cuda.empty_cache()
    # the training CLI on the model axis: one epoch of one clip
    cli_opt = Options(**{**TRAIN_RECIPE, **TRAIN_CLI, "name": "shard_train_cli"},
                      checkpoints_dir=root, n_devices=world, batchSize=1)
    dataset = SquareClips(*TRAIN_HW)
    dataset.clips = dataset.clips[:1]
    chunk_ms = []
    t1 = time.perf_counter()
    with torch_default_tf32(), timed(Trainer, "train_chunk", chunk_ms):
        cli_trainer, _ = train_cli.train(cli_opt, dataset=dataset, flow_fn=est)
        torch.cuda.synchronize(dev)
    seconds["cli"] = time.perf_counter() - t1
    sched = cli_trainer.schedule
    out["cli"] = dict(chunk_ms=chunk_ms, epoch=sched.epoch, total_steps=sched.total_steps,
                      digest=mesh.weights_digest(cli_trainer.gen, cli_trainer.engine))
    t1 = time.perf_counter()
    out["flow"] = shard_flow_rank(est, cli_trainer, dev)
    seconds["flow"] = time.perf_counter() - t1
    out["unsharded_launches"] = {"correlation": unsharded["correlation"] + correlation.launches,
                                 "flow_warp": unsharded["flow_warp"] + flow_warp.launches}
    out["seconds"] = seconds
    return out


# (H, W) of phase 14's FlowNet2 comparison: the recipe's frames, and the
# uneven width, which FlowNet2 resizes to 512 and back
SHARD_FLOW_HW = [TRAIN_HW, SHARD_TRAIN_UNEVEN_HW]


def shard_flow_rank(est: FlowEstimator, trainer: Trainer, dev: torch.device) -> dict:
    """On a rank of phase 14: the sharded FlowEstimator (the trainer's
    shard of the frames' width) on SHARD_FLOW_HW's frame pairs
    (frame_pairs(2, H, W), whole on every rank): this rank's flow and conf,
    and at FlowNet2's size its flow and warp error (CPU tensors), the host
    ms of a call after a warm-up call, and that call's exchanges and the
    bytes this rank sent."""
    out = {}
    for h, w in SHARD_FLOW_HW:
        im1, im2 = (t.to(dev) for t in frame_pairs(2, h, w, seed=5))
        sh = trainer.shard(w, h)
        est(im1, im2, shard=sh)  # warm-up
        torch.cuda.synchronize(dev)
        halo.reset_counts()
        t0 = time.perf_counter()
        flow, conf = est(im1, im2, shard=sh)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(halo.COUNTS)
        net_flow, err, _ = est.flow_and_error(im1[0], im2[0], sh)
        out[(h, w)] = dict(flow=flow.cpu(), conf=conf.cpu(), net_flow=net_flow.cpu(),
                           err=err.cpu(), ms=ms, exchanges=counts["exchanges"],
                           exchange_bytes=counts["exchange_bytes"], columns=(sh.x0, sh.width))
    return out


def shard_flow_compare(est: FlowEstimator, ranks: list) -> dict:
    """Phase 14: the ranks' FlowEstimator outputs (shard_flow_rank) side by
    side against the unsharded FlowEstimator on the same pairs here, by
    the CPU tests' criteria (tests/test_torch_shard_flow.py): the flow, at
    FlowNet2's size and after the resize back, within 1e-4 (1 + max|flow|);
    the confidence at FlowNet2's size equal wherever the unsharded warp
    error lies more than 1e-4 from the threshold (and, unresized, the
    returned confidence too). Raises off them; returns by (H, W) the
    unsharded call's host ms (after a warm-up call), the largest flow
    differences and the confidence's flips near the threshold."""
    thr, out = est.conf_threshold, {}
    for h, w in SHARD_FLOW_HW:
        im1, im2 = (t.to(DEV) for t in frame_pairs(2, h, w, seed=5))
        est(im1, im2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow, conf = est(im1, im2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        net_flow, err, _ = est.flow_and_error(im1[0], im2[0])
        got = {k: torch.cat([r["flow"][(h, w)][k] for r in ranks], -1).to(DEV)
               for k in ("flow", "conf", "net_flow", "err")}
        row = dict(ms_unsharded=ms)
        for k, want in (("flow", flow), ("net_flow", net_flow)):
            diff, atol = float((got[k] - want).abs().max()), 1e-4 * (1 + float(want.abs().max()))
            row[k + "_max_diff"], row[k + "_atol"] = diff, atol
            if not diff <= atol:
                raise AssertionError(f"shard_train FlowNet2 {h}x{w}: the ranks' {k} is off the "
                                     f"unsharded one by {diff} (atol {atol})")
        away = (err - thr).abs() > 1e-4
        flips = int(((got["err"] < thr) != (err < thr)).sum())
        row.update(conf_flips=flips, conf_flips_away=int(((got["err"] < thr) != (err < thr))[away]
                                                        .sum()),
                   conf_mean=float(conf.mean()))
        if row["conf_flips_away"] or (h, w) == tuple(net_flow.shape[-2:]) and not torch.equal(
                got["conf"][away.view(conf.shape)], conf[away.view(conf.shape)]):
            raise AssertionError(f"shard_train FlowNet2 {h}x{w}: the ranks' confidence differs "
                                 "away from the threshold")
        out[(h, w)] = row
        del im1, im2, flow, conf, net_flow, err, got
    torch.cuda.empty_cache()
    return out


def shard_bwd_case(args, n: int, dtype) -> float:
    """warp_blend_at_bwd on each of n shards (those with columns) of one
    case: against its plain version (compare), its d_raw, d_flow, d_weight
    bit for bit with the unsharded call's columns, and (f32) the shards'
    d_prev summed against the unsharded one's, within TOL; the max abs
    error against the plain version."""
    raw, prev, flow, weight, g = args
    want = warp_blend_bwd(*args)
    tol = TOL[("warp_blend_bwd", dtype)]
    dprev, err = torch.zeros(prev.shape, device=DEV), 0.0
    for sh in (halo.make_shard(i, n, raw.shape[3]) for i in range(n)):
        if not sh.width:
            continue
        local = [sh.local(t).contiguous() for t in (raw, flow, weight, g)]
        call = (local[0], prev, local[1], local[2], local[3], sh.x0)
        err = max(err, compare("warp_blend_bwd", call, dtype, warp_blend_at_bwd,
                               warp_blend_at_backward_plain))
        got = warp_blend_at_bwd(*call)
        for k in (0, 2, 3):
            if not torch.equal(got[k], sh.local(want[k])):
                raise AssertionError(f"warp_blend_at_bwd {dtype} {tuple(raw.shape)} shard "
                                     f"{sh.index} of {n}: output {k} differs from the "
                                     "unsharded call's columns")
        dprev += got[1].float()
    if dtype == torch.float32 and not torch.allclose(dprev, want[1], **tol):
        raise AssertionError(f"warp_blend_at_bwd {tuple(raw.shape)} on {n}: the shards' d_prev "
                             f"summed is off the unsharded call's by "
                             f"{float((dprev - want[1]).abs().max())}")
    return err


def shard_bwd_checks(gen: torch.Generator) -> None:
    """Phase 14: v2v_warp_blend_bwd at a column offset at SHARD_BWD_SHAPE on
    SHARD_TRAIN_RANKS shards, in bf16 and f32: each shard against its plain
    version (compare, warp_blend_bwd's TOL); x0 = 0 with the whole
    width against the unsharded entry (d_raw, d_flow, d_weight bit for bit;
    d_prev, which sums with atomics, within TOL); the shards' d_raw,
    d_flow, d_weight bit for bit with the unsharded call's columns and their
    d_prev (each over the whole frame) summed against its d_prev (f32,
    within TOL); and the times of the shards' calls against the unsharded
    call's (bf16: CUDA events), their plain versions' and grid_sample's
    backward at the shard's grid (SHARD_BWD); first the same checks,
    untimed, at SHARD_BWD_UNEVEN (shard_bwd_case)."""
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n in SHARD_BWD_UNEVEN:
            args = bwd_case("warp_blend_bwd", shape, dtype, gen)
            err = shard_bwd_case(args, n, dtype)
            say("halo_mode", kernel="warp_blend_at_bwd", shape="x".join(map(str, shape)),
                dtype=str(dtype)[6:], shards=n, max_abs_err=f"{err:.3g}",
                columns_bit_for_bit_with_unsharded=True)
    n = SHARD_TRAIN_RANKS
    for dtype in (torch.bfloat16, torch.float32):
        raw, prev, flow, weight, g = args = bwd_case("warp_blend_bwd", SHARD_BWD_SHAPE, dtype, gen)
        want = warp_blend_bwd(*args)
        at0 = warp_blend_at_bwd(*args, 0)
        tol = TOL[("warp_blend_bwd", dtype)]
        if not all(torch.equal(a, b) for k, (a, b) in enumerate(zip(at0, want)) if k != 1):
            raise AssertionError(f"warp_blend_at_bwd {dtype} at x0 = 0: differs from the "
                                 "unsharded call")
        if not torch.allclose(at0[1].float(), want[1].float(), **tol):
            raise AssertionError(f"warp_blend_at_bwd {dtype} at x0 = 0: d_prev off the "
                                 "unsharded call's")
        shards, dprev, err = [], torch.zeros(prev.shape, device=DEV), 0.0
        for sh in (halo.make_shard(i, n, SHARD_BWD_SHAPE[3]) for i in range(n)):
            local = [sh.local(t).contiguous() for t in (raw, flow, weight, g)]
            call = (local[0], prev, local[1], local[2], local[3], sh.x0)
            err = max(err, compare("warp_blend_bwd", call, dtype, warp_blend_at_bwd,
                                   warp_blend_at_backward_plain))
            got = warp_blend_at_bwd(*call)
            for k in (0, 2, 3):
                if not torch.equal(got[k], sh.local(want[k])):
                    raise AssertionError(f"warp_blend_at_bwd {dtype} shard {sh.index}: output "
                                         f"{k} differs from the unsharded call's columns")
            dprev += got[1].float()
            shards.append((sh, call))
        if dtype == torch.float32 and not torch.allclose(dprev, want[1], **tol):
            raise AssertionError("warp_blend_at_bwd: the shards' d_prev summed is off the "
                                 f"unsharded call's by {float((dprev - want[1]).abs().max())}")
        ms_whole = time_ms(warp_blend_bwd, args)
        ms_shards = [time_ms(warp_blend_at_bwd, call) for _, call in shards]
        plain = [time_ms(warp_blend_at_backward_plain, call) for _, call in shards]
        lib = [time_ms(grid_sample_backward(prev, call[2], call[4], sh.x0), ())
               for sh, call in shards]
        # read g, raw, flow, w at the shard's columns and prev's whole
        # frame; write d_raw, d_flow, d_w there and d_prev's whole frame
        b, c, h, w = SHARD_BWD_SHAPE
        size = torch.tensor([], dtype=dtype).element_size()
        nb = sum((2 * c + 3 + c + 2 + 1) * b * h * sh.width * size + 2 * c * b * h * w * size
                 for sh, _ in shards)
        nop = 40 * b * c * h * w
        SHARD_BWD[dtype] = dict(ms=sum(ms_shards), ms_shards=ms_shards, ms_unsharded=ms_whole,
                                plain_ms=sum(plain), library_ms=sum(lib), bytes=nb, ops=nop,
                                max_abs_err=err)
        say("halo_mode", kernel="warp_blend_at_bwd", shape="x".join(map(str, SHARD_BWD_SHAPE)),
            dtype=str(dtype)[6:], shards=n, x0=",".join(str(sh.x0) for sh, _ in shards),
            max_abs_err=f"{err:.3g}",
            columns_bit_for_bit_with_unsharded=True, x0_0_bit_for_bit_but_d_prev=True,
            ms_unsharded=f"{ms_whole:.4f}", ms_shards=",".join(f"{v:.4f}" for v in ms_shards),
            shards_over_unsharded=f"{sum(ms_shards) / ms_whole:.4f}",
            plain_ms_shards=",".join(f"{v:.4f}" for v in plain),
            grid_sample_backward_ms_shards=",".join(f"{v:.4f}" for v in lib))
        del args, want, at0, shards, dprev
    torch.cuda.empty_cache()


def sampled_pixels(flow: torch.Tensor, x0: int, wp: int, patch: bool) -> int:
    """The distinct pixels of a (B, ., H, Wp) image that the bilinear warp
    of this (B, 2, H, W) flow from column x0 reads: each sample's four
    corners, the floor and the one after it on each axis, clamped into the
    image as the forward clamps them, or with `patch` as the backward's
    patch formulation does (the floor clipped to [0, size - 2])."""
    b, _, h, w = flow.shape
    f = flow.float()
    sx = torch.arange(x0, x0 + w, device=f.device).view(1, 1, w) + f[:, 0]
    sy = torch.arange(h, device=f.device).view(1, h, 1) + f[:, 1]
    xi, yi = torch.floor(sx).long(), torch.floor(sy).long()
    if patch:
        xi, yi = xi.clamp(0, wp - 2), yi.clamp(0, h - 2)
    seen = torch.zeros((b, h * wp), dtype=torch.bool, device=f.device)
    for dy in (0, 1):
        for dx in (0, 1):
            idx = (yi + dy).clamp(0, h - 1) * wp + (xi + dx).clamp(0, wp - 1)
            seen.scatter_(1, idx.view(b, -1), True)
    return int(seen.sum())


def shard_warp_case(shape, n: int, timed: bool) -> dict:
    """flow_warp_at and flow_warp_at_bwd (f32, the losses' dtype) on each
    of n shards (those with columns) of one case (bwd_case's image, flow
    of several pixels and cotangent): each against its plain version
    (compare); the forward's columns and the backward's d_flow bit for bit
    with the unsharded flow_warp / flow_warp_bwd's columns; the shards'
    d_image (each over the whole frame) summed against the unsharded one
    (TOL). With `timed`, the shards' calls (events)
    summed against the unsharded call's, their plain versions' and
    grid_sample's (and its backward) at each shard's grid. Returns
    {entry: {max_abs_err, and with `timed` ms, ms_unsharded, plain_ms,
    library_ms, bytes, ops}}."""
    dtype = torch.float32
    image, flow, g = bwd_case("flow_warp_bwd", shape, dtype, torch.Generator().manual_seed(19))
    want, want_b = flow_warp(image, flow), flow_warp_bwd(image, flow, g)
    tol = TOL[("flow_warp_bwd", dtype)]
    out = {"flow_warp_at": dict(max_abs_err=0.0), "flow_warp_at_bwd": dict(max_abs_err=0.0)}
    dimage, calls = torch.zeros_like(image), []
    for sh in (halo.make_shard(i, n, shape[3]) for i in range(n)):
        if not sh.width:
            continue
        fl, gl = sh.local(flow).contiguous(), sh.local(g).contiguous()
        fwd, bwd = (image, fl, sh.x0), (image, fl, gl, sh.x0)
        for name, kernel, call in (("flow_warp", flow_warp_at, fwd),
                                   ("flow_warp_bwd", flow_warp_at_bwd, bwd)):
            row = out[kernel.__name__]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     compare(name, call, dtype, kernel, PLAIN_OF[kernel]))
        got_b = flow_warp_at_bwd(*bwd)
        if not torch.equal(flow_warp_at(*fwd), sh.local(want)) or \
                not torch.equal(got_b[1], sh.local(want_b[1])):
            raise AssertionError(f"flow_warp_at {shape} shard {sh.index} of {n}: differs from "
                                 "the unsharded entries' columns")
        dimage += got_b[0]
        calls.append((sh, fwd, bwd))
    if not torch.allclose(dimage, want_b[0], **tol):
        off = float((dimage - want_b[0]).abs().max())
        raise AssertionError(f"flow_warp_at_bwd {shape} on {n}: the shards' d_image summed is "
                             f"off the unsharded call's by {off}")
    if timed:
        b, c, h, w = shape
        fwd_lib = [(grid_sample, (image, sampling_grid(fwd[1], sh.x0, w))) for sh, fwd, _ in calls]
        bwd_lib = [(grid_sample_backward(image, bwd[1], bwd[2], sh.x0), ())
                   for sh, _, bwd in calls]
        for entry, kernel, whole, k, lib in (
                ("flow_warp_at", flow_warp_at, (flow_warp, (image, flow)), 1, fwd_lib),
                ("flow_warp_at_bwd", flow_warp_at_bwd, (flow_warp_bwd, (image, flow, g)), 2,
                 bwd_lib)):
            ms = [time_ms(kernel, call[k]) for call in calls]
            # the forward reads the image's pixels its samples reach
            # (sampled_pixels, measured from this run's flow) and the
            # shard's flow, and writes its columns; the backward reads the
            # pixels its patches reach and the shard's flow and cotangent,
            # writes d_image's whole frame (the entry's contract: the
            # splat, f32) and the shard's d_flow
            nb = 4 * sum(c * sampled_pixels(fwd[1], sh.x0, w, k == 2)
                         + ((2 + c) * sh.width if k == 1 else c * w + (4 + c) * sh.width) * b * h
                         for sh, fwd, _ in calls)
            out[entry].update(ms=sum(ms), ms_shards=ms, ms_unsharded=time_ms(*whole),
                              plain_ms=sum(time_ms(PLAIN_OF[kernel], call[k]) for call in calls),
                              library_ms=sum(time_ms(*fn_args) for fn_args in lib), bytes=nb,
                              ops=(10 if k == 1 else 40) * b * c * h * w)
    del image, flow, g, want, want_b, dimage, calls
    return out


def shard_warp_checks() -> None:
    """Phase 14: the loss engine's offset warps (v2v_flow_warp_at,
    v2v_flow_warp_at_bwd) checked untimed at SHARD_BWD_UNEVEN (odd local
    widths, 1-column shards), then checked and timed at SHARD_WARP_SHAPE
    on SHARD_TRAIN_RANKS shards (shard_warp_case), into SHARD_WARP."""
    for shape, n in SHARD_BWD_UNEVEN + [(SHARD_WARP_SHAPE, SHARD_TRAIN_RANKS)]:
        shape = (2,) + shape[1:]
        timed = shape == SHARD_WARP_SHAPE
        out = shard_warp_case(shape, n, timed)
        if timed:
            SHARD_WARP.update(out)
        for entry, row in out.items():
            say("offset_mode", kernel=entry, shape="x".join(map(str, shape)), dtype="float32",
                shards=n, max_abs_err=f"{row['max_abs_err']:.3g}",
                columns_bit_for_bit_with_unsharded=True,
                **({} if not timed else dict(
                    ms_unsharded=f"{row['ms_unsharded']:.4f}",
                    ms_shards=",".join(f"{v:.4f}" for v in row["ms_shards"]),
                    shards_over_unsharded=f"{row['ms'] / row['ms_unsharded']:.4f}",
                    plain_ms=f"{row['plain_ms']:.4f}",
                    grid_sample_ms_shards=f"{row['library_ms']:.4f}")))
    torch.cuda.empty_cache()


# the column-halo correlation (shard_corr_checks): held untimed at narrow,
# 1-column and empty shards and an odd width, (whole (B, C, H, W), shards),
# then checked and timed at SHARD_CORR_SHAPE, FlowNetC's 1/8 level of the
# recipe's two 256x512 pairs, on SHARD_TRAIN_RANKS shards
SHARD_CORR_UNEVEN = [((1, 64, 9, 24), 8), ((1, 32, 8, 5), 8), ((2, 256, 32, 65), 2)]
SHARD_CORR_SHAPE = CORR_SHAPES[2]
# its checks and times, and the ranks' launches, for the kernels' JSON
SHARD_CORR: dict = {}


def shard_corr_case(shape, n: int, timed: bool) -> dict:
    """correlation_halo on each of n shards (those with columns) of one
    seeded case, f2 with its 20-column halo cut from the whole tensor
    (halo.padded_plain: the neighbours' columns, zeros past the image's
    edges): against its plain version (compare, TOL["correlation"]), and
    against the unsharded kernel's columns, bit for bit where the two
    launches' plans agree (the same channel parts summed in one order),
    else within TOL. With `timed`, the shards' calls (events) summed
    against the unsharded call's and their plain versions'; the bound's
    bytes (f1's and the output's columns, f2's padded row) and FFMAs (one
    a tap inside the whole image: correlation_taps with x0)."""
    f1, f2 = corr_case(shape, torch.Generator().manual_seed(23))
    want = correlation(f1, f2)
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    b, c, h, w = shape
    tol, md = TOL[("correlation", torch.float32)], KERNEL_MAX_DISPLACEMENT
    out, calls = dict(max_abs_err=0.0, bit_for_bit=0), []
    for sh in (halo.make_shard(i, n, w) for i in range(n)):
        if not sh.width:
            continue
        call = (sh.local(f1).contiguous(),
                halo.padded_plain(f2, sh, md, md, "zeros").contiguous())
        out["max_abs_err"] = max(out["max_abs_err"], compare(
            "correlation", call, torch.float32, correlation_halo, correlation_halo_plain))
        got, cols = correlation_halo(*call), sh.local(want)
        if correlation_plan(b, c, h, sh.width, n_sm) == correlation_plan(b, c, h, w, n_sm):
            ok = torch.equal(got, cols)
            out["bit_for_bit"] += 1
        else:
            ok = torch.allclose(got, cols, **tol)
        if not ok:
            raise AssertionError(f"correlation_halo {shape} shard {sh.index} of {n}: off the "
                                 "unsharded kernel's columns")
        calls.append((sh, call))
    if timed:
        ms = [time_ms(correlation_halo, call) for _, call in calls]
        out.update(ms=sum(ms), ms_shards=ms, ms_unsharded=time_ms(correlation, (f1, f2)),
                   plain_ms=sum(time_ms(correlation_halo_plain, call) for _, call in calls),
                   bytes=4 * sum(b * c * h * (2 * sh.width + 2 * md) + b * 441 * h * sh.width
                                 for sh, _ in calls),
                   ops=sum(2.0 * b * c * correlation_taps(h, sh.width, sh.x0, w)
                           for sh, _ in calls))
    del f1, f2, want, calls
    return out


def shard_corr_checks() -> None:
    """Phase 14: FlowNetC's correlation in its column-halo mode
    (v2v_correlation_cols) checked untimed at SHARD_CORR_UNEVEN, then
    checked and timed at SHARD_CORR_SHAPE on SHARD_TRAIN_RANKS shards
    (shard_corr_case), into SHARD_CORR."""
    for shape, n in SHARD_CORR_UNEVEN + [(SHARD_CORR_SHAPE, SHARD_TRAIN_RANKS)]:
        timed = shape == SHARD_CORR_SHAPE
        row = shard_corr_case(shape, n, timed)
        if timed:
            SHARD_CORR.update(row)
        say("halo_mode", kernel="correlation_halo", shape="x".join(map(str, shape)),
            dtype="float32", shards=n, max_abs_err=f"{row['max_abs_err']:.3g}",
            shards_bit_for_bit_with_unsharded=row["bit_for_bit"],
            **({} if not timed else dict(
                ms_unsharded=f"{row['ms_unsharded']:.4f}",
                ms_shards=",".join(f"{v:.4f}" for v in row["ms_shards"]),
                shards_over_unsharded=f"{row['ms'] / row['ms_unsharded']:.4f}",
                plain_ms=f"{row['plain_ms']:.4f}",
                bound_ms=f"{bound_ms(row['bytes'], row['ops'], F32_FLOPS)[0]:.4f}")))
    torch.cuda.empty_cache()


def shard_train_path(card: str, seen: dict) -> dict:
    """Phase 14: training's model axis (--n_devices 2 at batch 1: data 1 x
    model 2) at the 512x256 recipe's full width, on SHARD_TRAIN_RANKS gloo
    ranks on this one card (NCCL refuses two ranks on one device):
      - the unsharded Trainer here first, from the same seeded weights and
        flow (at both widths);
      - the ranks' chunk 1 with the generator in f32 against the unsharded
        one's within the training bounds (out_of_bounds); the recipe's
        bf16 chunk 2's differences printed; the ranks' losses and weights
        equal bit for bit after every chunk;
      - every blend of the ranks' generator, forward and backward, at its
        column offset (warp_blend_at, warp_blend_at_bwd; no unsharded
        warp_blend call), and every warp of the loss engine (F_Warp and
        G_Warp: flow_warp_at, and F_Warp's backward flow_warp_at_bwd; no
        unsharded flow_warp_bwd call), their calls sent back for 3b; the
        offset backward of the blend and both offset warps checked and
        timed against the unsharded calls (shard_bwd_checks,
        shard_warp_checks);
      - netD, every netD_T and VGG on the ranks' columns: netD's finest
        layer saw each rank's columns (256 of 512);
      - FlowNet2 on the ranks' columns (flow_fn(..., shard=)): every
        correlation in its column-halo mode and every warp at its offset
        over a rank's whole run (no unsharded correlation or flow_warp
        launch); the sharded FlowEstimator against the unsharded one at
        SHARD_FLOW_HW (shard_flow_rank, shard_flow_compare), and the
        column-halo correlation checked and timed (shard_corr_checks);
      - the uneven width: one f32 chunk at SHARD_TRAIN_UNEVEN_HW (the
        trunk's 65 columns split 32 / 33) on the same ranks against the
        unsharded Trainer's within the training bounds, the ranks bit for
        bit, its calls sent back for 3b;
      - ms a chunk a rank, the exchanges and gathers a chunk forward and
        backward with their bytes, each chunk's collectives by caller with
        their host ms and the card's queued work they waited for
        (collective_times), the G gradients' reduction ms and bytes, peak
        memory a rank beside the unsharded Trainer's;
      - train_cli.train on both ranks for one epoch of one clip: equal
        weights, `latest` written once.
    Two ranks share one card: no scaling figure. Returns the launch counts
    of both ranks' counted runs, summed."""
    labels, frames = shard_train_clip()
    uneven = shard_train_clip(SHARD_TRAIN_UNEVEN_HW, SHARD_TRAIN_UNEVEN_FRAMES)
    trainer = Trainer(Options(**TRAIN_RECIPE),
                      flow_fn=seeded_flow_estimator(DEV, seed=3, tf32_seen=[]), device=DEV)
    ref = shard_train_reference(trainer, labels, frames)
    ref_u = shard_train_reference(trainer, *uneven)
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_train_")
    try:
        t0 = time.perf_counter()
        ranks = launch(shard_train_rank, SHARD_TRAIN_RANKS,
                       args=(labels, frames, str(DEV), root, uneven),
                       devices=[DEV] * SHARD_TRAIN_RANKS,
                       backend="gloo", deadline_s=SHARD_TRAIN_DEADLINE_S)
        launch_s = time.perf_counter() - t0
        cli_files = sorted(os.listdir(os.path.join(root, "shard_train_cli")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flows = shard_flow_compare(trainer.flow_fn, ranks)
    del trainer
    torch.cuda.empty_cache()
    first = ranks[0]
    keys = sorted(ref["losses"][0])
    bf16_rel = {k: abs(first["losses"][1][k] - ref["losses"][1][k])
                / max(abs(ref["losses"][1][k]), 1e-12) for k in sorted(ref["losses"][1])}
    n = len(first["counts"])
    per_chunk = {k: sum(c[k] for c in first["counts"]) / n for k in first["counts"][0]}
    say("shard_train_path", config="label2city 512x256 ngf128 fg bf16 remat, FlowNet2 f32 "
        f"(recipes/street/train_512.sh), --n_devices {SHARD_TRAIN_RANKS} --batchSize 1: data 1 x "
        f"model {SHARD_TRAIN_RANKS} (recipe: model 8), gloo ranks on this one card, one clip of "
        f"{SHARD_TRAIN_FRAMES} frames (2 chunks of 2: chunk 1 with the "
        "generator in f32, the rest in the recipe's bf16, timed and counted); deterministic "
        "algorithms",
        sharded="G, netD, every netD_T, VGG, the losses (each rank's share), the loss warps "
        "at their offset, FlowNet2 and its confidence (the correlation in its column-halo "
        "mode, the warps at their offset); whole on every rank: the face D (not in this "
        "recipe)",
        launch_s=f"{launch_s:.1f}", reference_s=f"{ref['seconds']:.1f}",
        rank_s=json.dumps([{k: round(v, 1) for k, v in r["seconds"].items()} for r in ranks]),
        columns=json.dumps([r["columns"] for r in ranks]),
        ms_per_chunk_unsharded_before=",".join(f"{v:.1f}" for v in ref["ms"]),
        ms_per_chunk_ranks=json.dumps([[round(v, 1) for v in r["ms"]] for r in ranks]),
        ms_is="chunk 1 f32, the others bf16",
        order="unsharded,sharded",
        collectives_per_chunk_rank0=json.dumps(per_chunk),
        collective_ms_by_caller_rank0=json.dumps(
            [{k: [v[0], round(v[1], 1), round(v[2], 1)] for k, v in sorted(c.items())}
             for c in first["collective_ms"]]),
        collective_ms_is="per chunk (chunk 1 f32, then bf16): {caller: [calls, ms in the "
        "collective, ms its synchronize waited for the card's queued work]}",
        collective_ms_total_rank0=",".join(f"{sum(v[1] for v in c.values()):.1f}"
                                           for c in first["collective_ms"]),
        collective_wait_ms_total_rank0=",".join(f"{sum(v[2] for v in c.values()):.1f}"
                                                for c in first["collective_ms"]),
        g_reduce_ms_ranks=",".join(f"{r['g_reduce_ms']:.1f}" for r in ranks),
        g_reduce_bytes=first["g_reduce_bytes"],
        peak_mem_gib_ranks=",".join(f"{r['peak'] / 2**30:.3f}" for r in ranks),
        peak_mem_gib_unsharded=f"{ref['peak'] / 2**30:.3f}",
        peak_mem_gib_by_step_rank0=json.dumps({k: round(v / 2**30, 3)
                                               for k, v in first["step_peaks"].items()}),
        peak_mem_gib_by_step_unsharded=json.dumps({k: round(v / 2**30, 3)
                                                   for k, v in ref["step_peaks"].items()}),
        f32_chunk1=json.dumps({k: [first["losses"][0][k], ref["losses"][0][k]] for k in keys}),
        bf16_chunk2_rel_diff=json.dumps({k: float(f"{v:.3g}") for k, v in bf16_rel.items()}),
        loss_G_total=",".join(f"{c['loss_G_total']:.6g}" for c in first["losses"]),
        loss_G_total_unsharded=",".join(f"{c['loss_G_total']:.6g}" for c in ref["losses"]),
        G_grad_norm=",".join(f"{c['G_grad_norm']:.6g}" for c in first["losses"]),
        G_grad_norm_unsharded=",".join(f"{c['G_grad_norm']:.6g}" for c in ref["losses"]),
        offset_launches_per_rank=json.dumps(first["offset_launches"]),
        cli_ms_per_chunk=",".join(f"{v:.1f}" for v in first["cli"]["chunk_ms"]),
        cli_files=",".join(cli_files), scaling="none: two ranks share one card over gloo",
        uneven=f"{SHARD_TRAIN_UNEVEN_HW[0]}x{SHARD_TRAIN_UNEVEN_HW[1]}, one f32 chunk",
        uneven_columns_finest_and_trunk=json.dumps([r["uneven"]["columns"] for r in ranks]),
        uneven_f32_chunk1=json.dumps({k: [first["uneven"]["losses"][0][k],
                                          ref_u["losses"][0][k]] for k in keys}),
        card=repr(card))
    for (h, w), row in flows.items():
        say("shard_flow", frames=f"2 pairs {h}x{w}", shards=SHARD_TRAIN_RANKS,
            columns=json.dumps([r["flow"][(h, w)]["columns"] for r in ranks]),
            exchanges_per_call_ranks=json.dumps([r["flow"][(h, w)]["exchanges"] for r in ranks]),
            exchange_bytes_per_call_ranks=json.dumps([r["flow"][(h, w)]["exchange_bytes"]
                                                      for r in ranks]),
            ms_per_call_ranks=",".join(f"{r['flow'][(h, w)]['ms']:.1f}" for r in ranks),
            ms_per_call_unsharded=f"{row['ms_unsharded']:.1f}",
            ms_is="host clock around one call after a warm-up, synchronized; the ranks' "
            "calls ran together on this card, the unsharded one alone after them",
            flow_max_diff=f"{row['flow_max_diff']:.3g}", flow_atol=f"{row['flow_atol']:.3g}",
            net_flow_max_diff=f"{row['net_flow_max_diff']:.3g}",
            conf_flips_near_threshold=row["conf_flips"], conf_flips_away=row["conf_flips_away"],
            conf_mean=f"{row['conf_mean']:.4f}", card=repr(card))
    for r in ranks[1:]:
        if r["digests"] != first["digests"] or r["losses"] != first["losses"]:
            raise AssertionError("shard_train: the ranks' weights or losses differ")
        if r["cli"]["digest"] != first["cli"]["digest"]:
            raise AssertionError("shard_train: the CLI's ranks end with different weights")
        if r["uneven"]["digests"] != first["uneven"]["digests"] or \
                r["uneven"]["losses"] != first["uneven"]["losses"]:
            raise AssertionError("shard_train uneven: the ranks' weights or losses differ")
    if len(first["digests"]) != 2 or first["mesh"] != {"data": 1, "model": SHARD_TRAIN_RANKS}:
        raise AssertionError(f"shard_train: {len(first['digests'])} chunks on {first['mesh']}")
    bad = out_of_bounds(first["losses"][:1], ref["losses"][:1], keys)
    if bad:
        raise AssertionError(f"shard_train: f32 chunk 1 against the unsharded Trainer: {bad}")
    bad = out_of_bounds(first["uneven"]["losses"][:1], ref_u["losses"][:1], keys)
    if bad:
        raise AssertionError(f"shard_train uneven {SHARD_TRAIN_UNEVEN_HW}: f32 chunk 1 against "
                             f"the unsharded Trainer: {bad}")
    for c in first["losses"] + first["uneven"]["losses"]:
        if not all(math.isfinite(v) for v in c.values()):
            raise AssertionError(f"shard_train: non-finite loss {c}")
    if (first["cli"]["epoch"], first["cli"]["total_steps"]) != (2, 1) or not any(
            f.endswith("net_G0.pth") for f in cli_files):
        raise AssertionError(f"shard_train CLI: schedule {first['cli']}, files {cli_files}")
    launches = collections.Counter()
    for rank in ranks:
        at = rank["offset_launches"]
        if at["warp_blend_at"] == 0 or at["warp_blend_at_bwd"] == 0 or at["warp_blend"] or \
                at["warp_blend_bwd"]:
            raise AssertionError(f"shard_train: the blend's launches {at}: want every one at "
                                 "its column offset")
        if at["flow_warp_at"] == 0 or at["flow_warp_at_bwd"] == 0 or at["flow_warp_bwd"]:
            raise AssertionError(f"shard_train: the loss warps' launches {at}: want every one "
                                 "at its column offset")
        if rank["d_widths"] != [labels.shape[-1] // SHARD_TRAIN_RANKS]:
            raise AssertionError(f"shard_train: netD's finest layer saw widths "
                                 f"{rank['d_widths']}, not the rank's columns")
        for name in ("flow_warp", "correlation"):  # FlowNet2, on the rank's columns
            if rank["launches"][name] == 0:
                raise AssertionError(f"shard_train: a rank never launched {name}")
        if at["correlation_halo"] == 0 or any(rank["unsharded_launches"].values()):
            raise AssertionError(f"shard_train: FlowNet2's launches {at}, unsharded over the "
                                 f"rank's run {rank['unsharded_launches']}: want every "
                                 "correlation in its column-halo mode, every warp at its "
                                 "offset")
        launches.update(rank["launches"])
        for name, i, shapes, dtype, calls in rank["seen"] + rank["uneven"]["seen"]:
            key = (name, COUNTERS[name][i], shapes, getattr(torch, dtype.split(".")[1]))
            seen[key] = seen.get(key, 0) + calls
    SHARD_BWD["launches"] = sum(r["offset_launches"]["warp_blend_at_bwd"] for r in ranks)
    SHARD_CORR["launches"] = sum(r["offset_launches"]["correlation_halo"] for r in ranks)
    for entry in ("flow_warp_at", "flow_warp_at_bwd"):
        SHARD_WARP[entry + "_launches"] = sum(r["offset_launches"][entry] for r in ranks)
    t0 = time.perf_counter()
    shard_bwd_checks(torch.Generator().manual_seed(14))
    shard_warp_checks()
    shard_corr_checks()
    say("shard_train_checks", f32_chunk1_within_training_bounds=True,
        ranks_equal_bit_for_bit=True, cli_ranks_equal=True,
        blends_and_loss_warps_at_their_offset=True,
        flownet2_on_the_ranks_columns_within_the_unsharded_criteria=True,
        unsharded_flownet2_launches_on_the_ranks=0,
        d_finest_layer_widths=json.dumps([r["d_widths"] for r in ranks]),
        bwd_checks_s=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(dict(launches)))
    return {name: launches[name] for name in COUNTERS}


class SquareClips:
    """Two 8-frame moving-square clips (numpy seed 0) at H x W in
    data/temporal.py::TemporalDataset's item layout: "A" (T, H, W) int32
    labels, which serve as the instance map too, "B" (T, 3, H, W) in
    [-1, 1]."""

    seq_len_max = 8

    def __init__(self, h: int, w: int):
        rng = np.random.default_rng(0)
        self.clips = [moving_square_clip(rng, self.seq_len_max, h, w, 35) for _ in range(2)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        labels, frames = self.clips[i]
        return {"A": labels[0], "B": frames[0], "inst": labels[0], "A_path": f"clip{i}",
                "seq": i}


@contextlib.contextmanager
def timed(owner, attr: str, ms: list, outs: list | None = None):
    """Within the block, each call of owner.attr appends its host ms, up to
    a synchronize, to `ms` (and its result to `outs`)."""
    fn = getattr(owner, attr)

    def call(*args, **kwargs):
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        if outs is not None:
            outs.append(out)
        return out

    setattr(owner, attr, call)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def train_state_tensors(trainer: Trainer, state) -> dict:
    """Every tensor a checkpoint holds (the weights but VGG's, each Adam's
    moments and steps), and each optimizer's learning rates, by name."""
    out = {f"G.{k}": v for k, v in trainer.gen.state_dict().items()}
    out.update({f"D.{k}": v for k, v in trainer.engine.state_dict().items()
                if not k.startswith("vgg.")})
    for name, o in [("opt_g", state.opt_g), ("opt_d", state.opt_d)] + [
            (f"opt_dt{s}", o) for s, o in enumerate(state.opt_dt)]:
        for i, st in o.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
        out[f"{name}.lr"] = torch.tensor([g["lr"] for g in o.param_groups], dtype=torch.float64)
    return out


def train_cli_path(card: str) -> dict:
    """Phase 7b: the training CLI at the 512x256 recipe's full width; the
    launch counts of its epoch and of the saved generator's stream, summed."""
    (h, w), n_stream = TRAIN_HW, 4
    root = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    try:
        opt = Options(**TRAIN_RECIPE, **TRAIN_CLI, checkpoints_dir=root)
        dataset = SquareClips(h, w)
        est = seeded_flow_estimator(DEV, seed=3, tf32_seen=[])
        clip_ms, chunk_ms, refresh_ms, save_ms, clip_outs, saved = [], [], [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        with torch_default_tf32(), timed(Trainer, "train_clip", clip_ms, clip_outs), \
                timed(Trainer, "train_chunk", chunk_ms), \
                timed(train_cli, "refresh_batch_stats", refresh_ms), \
                timed(train_cli, "save_checkpoint", save_ms):
            timed_save = train_cli.save_checkpoint

            def save_and_record(opt_, state_, schedule, tag="latest"):
                saved.append((tag, schedule_fields(schedule)))
                timed_save(opt_, state_, schedule, tag)

            train_cli.save_checkpoint = save_and_record  # timed() puts the original back
            reset_launches()
            t0 = time.perf_counter()
            trainer, state = train_cli.train(opt, dataset=dataset, flow_fn=est)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launches = read_launches()
        train_peak = torch.cuda.max_memory_allocated()
        sched = trainer.schedule
        if (len(clip_ms), len(chunk_ms), sched.epoch, sched.total_steps) != (2, 6, 2, 6):
            raise AssertionError(f"{len(clip_ms)} clips, {len(chunk_ms)} chunks, schedule "
                                 f"{schedule_fields(sched)}: want 2 clips, 6 chunks")
        if [tag for tag, _ in saved] != ["latest"] or len(refresh_ms) != 1:
            raise AssertionError(f"saves {saved}, refreshes {len(refresh_ms)}: want one")
        for _, losses in clip_outs:
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"non-finite training loss {losses}")
        for name in ("warp_blend", "warp_blend_bwd", "flow_warp", "flow_warp_bwd",
                     "correlation"):
            if train_launches[name] == 0:
                raise AssertionError(f"train_cli: {name} never launched ({train_launches})")
        run_dir = os.path.join(root, opt.name)
        files = sorted(os.listdir(run_dir))
        ckpt = [f for f in files if f.endswith(".pth")]
        if ckpt != ["latest_net_D.pth", "latest_net_D_T0.pth", "latest_net_D_T1.pth",
                    "latest_net_G0.pth", "latest_optim.pth"]:
            raise AssertionError(f"checkpoint files {files}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(run_dir, f)) for f in ckpt)

        # restore into a fresh Trainer: bit for bit against the live one,
        # which has not changed since the save (the decay factor stays 1)
        fresh = Trainer(opt, flow_fn=est, device=DEV)
        fstate = fresh.init_state()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fstate, fsched = restore_checkpoint(opt, fstate, fresh.schedule)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        if schedule_fields(fsched) != saved[0][1]:
            raise AssertionError(f"schedule {schedule_fields(fsched)}, saved {saved[0][1]}")
        want, got = train_state_tensors(trainer, state), train_state_tensors(fresh, fstate)
        differ = [k for k in want if k not in got or got[k].dtype != want[k].dtype
                  or not torch.equal(got[k], want[k])]
        if differ or got.keys() != want.keys():
            raise AssertionError(f"restored state differs at {differ[:8]} ({len(differ)})")
        n_tensors, n_moments = len(want), sum(k.endswith("exp_avg_sq") for k in want)

        # one chunk from each state, on the same inputs
        labels, frames = (torch.from_numpy(a).to(DEV) for a in dataset.clips[0])
        chunk = []
        with torch_default_tf32():
            for tr, st in ((fresh, fstate), (trainer, state)):
                _, _, losses = tr.train_chunk(st, tr.start_clip(), labels[:, :4],
                                              frames[:, :4], labels[:, :4])
                chunk.append(losses)
        if chunk[0].keys() != chunk[1].keys():
            raise AssertionError(f"restored vs live chunk: keys {chunk[0].keys()} vs "
                                 f"{chunk[1].keys()}")
        bad = out_of_bounds(chunk[:1], chunk[1:], sorted(chunk[1]))
        if bad:
            raise AssertionError("restored vs live chunk: " + "; ".join(bad))
        worst = max(abs(chunk[0][k] - chunk[1][k]) for k in chunk[1])
        phase_peak = torch.cuda.max_memory_allocated()
        del trainer, state, fresh, fstate, est, want, got
        torch.cuda.empty_cache()

        # the saved generator, streamed in eval mode and bf16
        stream_opt = Options(**{**TRAIN_RECIPE, "isTrain": False}, checkpoints_dir=root,
                             name=opt.name, how_many=n_stream)
        eng = InferenceEngine(stream_opt, device=DEV)
        if not test_cli.load_weights(stream_opt, eng):
            raise AssertionError("test_cli.load_weights found no latest_net_G0.pth")
        items = [{"A": labels[0, t].cpu().numpy(), "inst": labels[0, t].cpu().numpy(),
                  "change_seq": t == 0, "path": f"frame{t:02d}"}
                 for t in range(n_stream + opt.n_frames_G - 1)]
        reset_launches()
        stream_ms, fakes = [], []
        t1 = time.perf_counter()
        for _, fake in test_cli.stream_frames(stream_opt, eng, items):
            torch.cuda.synchronize()
            stream_ms.append((time.perf_counter() - t1) * 1e3)
            fakes.append(fake)
            t1 = time.perf_counter()
        stream_launches = read_launches()
        if len(fakes) != n_stream:
            raise AssertionError(f"{len(fakes)} streamed frames, want {n_stream}")
        check_frames(fakes, (1, 3, h, w), "train_cli stream")
        for name in ("respair", "conv7"):
            if stream_launches[name] == 0:
                raise AssertionError(f"train_cli stream: {name} never launched")
        del eng, fakes
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: train_launches[k] + stream_launches[k] for k in train_launches}
    say("train_cli", config="label2city 512x256 ngf128 fg bf16 remat, FlowNet2 f32, "
        "2 clips x 3 chunks, latest saved once", train_s=f"{train_s:.2f}",
        ms_per_clip=",".join(f"{v:.1f}" for v in clip_ms),
        ms_per_chunk=",".join(f"{v:.1f}" for v in chunk_ms),
        ms_per_chunk_median=f"{statistics.median(chunk_ms):.2f}",
        checkpoint_bytes=ckpt_bytes, save_s=f"{save_ms[0] / 1e3:.2f}",
        restore_s=f"{restore_s:.2f}", refresh_s=f"{refresh_ms[0] / 1e3:.2f}",
        restored_tensors_bit_for_bit=n_tensors, adam_params=n_moments,
        restored_vs_live_worst_abs=f"{worst:.3g}",
        loss_G_total=",".join(f"{c['loss_G_total']:.5g}" for c in chunk),
        train_peak_mem_gib=f"{train_peak / 2**30:.3f}",
        phase_peak_mem_gib=f"{phase_peak / 2**30:.3f}",
        stream_ms_per_frame=",".join(f"{v:.1f}" for v in stream_ms),
        train_launches=json.dumps(train_launches), stream_launches=json.dumps(stream_launches),
        card=repr(card))
    return launches


def say_profile(phase: str, profile) -> None:
    """One line: a profiled call's wall and kernel ms, and ms by family."""
    families, busy_ms, wall = profile
    say(phase, wall_ms=f"{wall:.2f}", kernel_ms=f"{busy_ms:.2f}",
        families=json.dumps({f: [round(ms, 3), n] for f, ms, n in families}))


def check_frames(frames, shape, what: str) -> None:
    """Finite float32 frames of the shape, within the tanh range."""
    for f in frames:
        if tuple(f.shape) != shape or f.dtype != torch.float32:
            raise AssertionError(f"{what}: frame {tuple(f.shape)} {f.dtype}")
        if not torch.isfinite(f).all():
            raise AssertionError(f"{what}: non-finite frame")
        if float(f.abs().max()) > 1 + 1e-2:
            raise AssertionError(f"{what}: |frame| {float(f.abs().max())} > 1 + 1e-2")


def seed_stats(seed_ms: list) -> dict:
    """The single-image first-frame metric: median ms per first frame over
    the timed seeding calls, and their spread."""
    return dict(ms_per_single_g_frame_median=f"{statistics.median(seed_ms):.2f}",
                ms_per_single_g_frame_min=f"{min(seed_ms):.2f}",
                ms_per_single_g_frame_max=f"{max(seed_ms):.2f}",
                ms_per_single_g_frame_by_call=",".join(f"{v:.1f}" for v in seed_ms))


def seeded_stream(path: str, eng, seed_fn, n_seed: int, windows, n_frames: int):
    """Seed the state n_seed times (the single-image nets, two frames a
    call; the caller has made a warm-up call and reset the launch counts),
    then stream n_frames frames through eng.step from the last seed. Returns
    (ms per seeded frame per call, ms per streamed frame, the seeded state,
    the frames); host clock around torch.cuda.synchronize(). The launch
    counts of the seeding calls alone go into SEED_LAUNCHES[path]."""
    seed_ms, times, fakes = [], [], []
    for _ in range(n_seed):
        t1 = time.perf_counter()
        state = seed_fn()
        torch.cuda.synchronize()
        seed_ms.append((time.perf_counter() - t1) * 1e3 / 2)
    SEED_LAUNCHES[path] = read_launches()
    seeded = state
    for t in range(n_frames):
        t1 = time.perf_counter()
        fake, state = eng.step(*windows(t), state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        fakes.append(fake)
    return seed_ms, times, seeded, fakes


def edge2face_single_path(card: str) -> dict:
    """Phase 8a: edge2face 512x512 with --use_single_G: two first frames
    from the registry's GlobalWithFeatures (f32), fed by the Encoder and
    the face-feature lookup over seeded clusters, then the single-scale
    stream (bf16), under PyTorch's default TF32 flags (the engine turns
    cuDNN's TF32 off for the nets itself). Returns the kernels' launch
    counts on it."""
    opt = Options(**EDGE2FACE)
    h, w = FACE_HW
    n_frames, warm, n_seed = 10, 2, 5
    t0 = time.perf_counter()
    eng = seeded_engine(opt, DEV, seed=4)
    eng.build_single_g()
    seed_net(eng.single_g, 5)
    seed_net(eng.encoder, 6)
    tf32_seen = []
    watch_tf32(tf32_seen, eng.single_g, eng.encoder)
    edges, real, parts, clusters = face_inputs(n_frames + 2, h, w, 12, 50, seed=4)
    edges, real, parts = edges.to(DEV), real.to(DEV), parts.to(DEV)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def seed_fn():
        return eng.single_g_first_frames(edges[:, :2], real, parts, clusters)

    with torch_default_tf32():
        seed_fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        seed_ms, times, seeded, fakes = seeded_stream(
            "edge2face_single", eng, seed_fn, n_seed, lambda t: (edges[:, t : t + 3], None),
            n_frames)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        profile = profile_by_family(seed_fn, "one edge2face seeding call (2 frames)",
                                    out_path("chip_smoke_profile_edge2face_single.txt"), DEV)
        check_f32_convs(tf32_seen, "the single-image nets")
    stream_profile = profile_by_family(
        lambda: eng.step(edges[:, n_frames - 1 : n_frames + 2], None, seeded),
        "one edge2face 512x512 streamed frame", out_path("chip_smoke_profile_edge2face.txt"),
        DEV)
    check_frames(seeded[0][0].float(), (3, h, w), "edge2face single-image frame")
    check_frames(fakes, (1, 3, h, w), "edge2face stream")
    want = dict.fromkeys(KERNELS, 0) | {
        "conv7": 4 * 2 * n_seed + 5 * n_frames,
        "respair": 9 * 2 * n_seed + 18 * n_frames, "warp_blend": n_frames}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    say("edge2face_single_path",
        config="edge2face 512x512 --use_single_G: GlobalWithFeatures ngf64 + Encoder "
        "f32, then 1-scale ngf128 bf16", seed_calls=n_seed, frames=n_frames,
        setup_s=f"{setup_s:.1f}", **seed_stats(seed_ms),
        net_cudnn_allow_tf32=sorted(set(tf32_seen)), ms_per_frame_median=f"{statistics.median(times[warm:]):.2f}",
        ms_per_frame=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        card=repr(card))
    say_profile("edge2face_single_profile", profile)
    say_profile("edge2face_stream_profile", stream_profile)
    return launches


def label2city_single_path(card: str) -> dict:
    """Phase 8b: label2city 2048x1024 seeded by the city-2048 registry's
    LocalEnhancer (f32, the one-hot labels without the instance channel),
    then the flagship stream, under PyTorch's default TF32 flags. Returns
    the kernels' launch counts on it."""
    opt = Options(**FLAGSHIP, dataroot="datasets/Cityscapes/", loadSize=2048,
                  use_single_G=True)
    h, w = CITY_HW
    n_frames, warm, n_seed = 4, 2, 5
    t0 = time.perf_counter()
    eng = seeded_engine(opt, DEV, seed=6)
    if not isinstance(eng.build_single_g(), LocalEnhancer):
        raise AssertionError("label2city 2048 registry: not a LocalEnhancer")
    seed_net(eng.single_g, 7)
    tf32_seen = []
    watch_tf32(tf32_seen, eng.single_g)
    labels, inst = label_stream(opt, n_frames, h, w)
    enc = eng.encode(labels[:, :2], inst[:, :2])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def seed_fn():
        return eng.single_g_first_frames(enc)

    with torch_default_tf32():
        seed_fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        seed_ms, times, seeded, fakes = seeded_stream(
            "label2city_single", eng, seed_fn, n_seed,
            lambda t: (labels[:, t : t + 3], inst[:, t : t + 3]), n_frames)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        profile = profile_by_family(seed_fn, "one label2city seeding call (2 frames)",
                                    out_path("chip_smoke_profile_label2city_single.txt"), DEV)
        check_f32_convs(tf32_seen, "the single-image nets")
    memory = seeding_memory(eng, seed_fn, lambda: eng.step(labels[:, :3], inst[:, :3], seeded))
    check_frames(seeded[0][0].float(), (3, h, w), "label2city single-image frame")
    check_frames(fakes, (1, 3, h, w), "label2city seeded stream")
    want = dict.fromkeys(KERNELS, 0) | {
        "conv7": 3 * 2 * n_seed + 21 * n_frames,
        "respair": 12 * 2 * n_seed + 45 * n_frames, "warp_blend": 3 * n_frames}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    say("label2city_single_path",
        config="label2city 2048x1024 --use_single_G: LocalEnhancer ngf32 f32, then "
        "3-scale ngf128 fg bf16", seed_calls=n_seed, frames=n_frames,
        setup_s=f"{setup_s:.1f}", **seed_stats(seed_ms),
        net_cudnn_allow_tf32=sorted(set(tf32_seen)), ms_per_frame_median=f"{statistics.median(times[warm:]):.2f}",
        ms_per_frame=",".join(f"{v:.1f}" for v in times),
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        card=repr(card))
    say_profile("label2city_single_profile", profile)
    say("label2city_single_memory", **memory)
    return launches


def host_ms(fn, *args):
    """(fn(*args), its host ms)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def stream_items(opt: Options, eng, items: list, card: str, what: str, config: str,
                 build_ms: list, extra: dict) -> dict:
    """Stream `items` through test_cli.stream_frames (the CLI's loop), each
    frame timed on the host clock up to a synchronize; the launch counts
    of the run, checked (respair, conv7 and warp_blend launched), and one
    line. The first frame of the stream includes its sequence's seeding."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, fakes = [], []
    t1 = time.perf_counter()
    for _, fake in test_cli.stream_frames(opt, eng, items):
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        fakes.append(fake)
        t1 = time.perf_counter()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if len(fakes) != len(items) - opt.n_frames_G + 1:
        raise AssertionError(f"{what}: {len(fakes)} frames from {len(items)} items")
    h, w = items[0]["A"].shape[:2]
    check_frames(fakes, (1, 3, h, w), what)
    for name in ("respair", "conv7", "warp_blend"):
        if launches[name] == 0:
            raise AssertionError(f"{what}: {name} never launched ({launches})")
    say(what, config=config, frames=len(fakes), frame_hw=f"{h}x{w}",
        host_build_ms_per_frame_median=f"{statistics.median(build_ms):.2f}",
        host_build_ms=",".join(f"{v:.1f}" for v in build_ms),
        ms_per_frame_median=f"{statistics.median(step_ms[1:]):.2f}",
        ms_per_frame=",".join(f"{v:.1f}" for v in step_ms), **extra,
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches), card=repr(card))
    return launches


def face_stream_path(card: str) -> dict:
    """Phase 8c: edge2face 512x512 served through the test CLI's loop with
    --use_single_G: each frame's 15 channels and part map built by
    data/face.py::build_face_frame from 68 seeded landmarks and a seeded
    frame (the landmark edges with the Canny edges outside the face, 14
    distance maps), then the GlobalWithFeatures seeding (f32) and the bf16
    stream at full width. Returns the launch counts."""
    opt = Options(**FACE_STREAM)
    (h, w), n_items = FACE_STREAM_HW, 8
    rng = np.random.default_rng(0)
    frames = []
    for t in range(n_items):
        pts = face_landmarks(rng, w / 2 + (t % 3), h / 2 - 10 + t, FACE_WIDTH)
        frames.append((pts, face_image(rng, h, w, pts)))
    crop_box = face.face_crop_box(frames[0][0], (w, h))
    params = get_img_params(opt, (crop_box[3] - crop_box[2], crop_box[1] - crop_box[0]),
                            random.Random(0), np.random.RandomState(0))
    if crop_box != (0, h, 0, w) or target_size(opt, params) != (w, h):
        raise AssertionError(f"face crop {crop_box}, resize to {target_size(opt, params)}: "
                             f"want the whole {w}x{h} frame, kept")
    items, build_ms = [], []
    for t, (pts, rgb) in enumerate(frames):
        (a, b, label), ms = host_ms(face.build_face_frame, pts, rgb, opt, params, crop_box)
        build_ms.append(ms)
        items.append({"A": a, "B": b, "inst": label, "change_seq": t == 0,
                      "path": f"face{t:02d}"})
    gray = raster.rgb_to_gray(frames[0][1])
    _, canny_ms = host_ms(raster.canny, gray, 100, 200)
    _, dist_ms = host_ms(face.distance_maps, face.draw_part_edges(
        face.extend_keypoints(frames[0][0]), (w, h))[1])
    eng = seeded_engine(opt, DEV, seed=8)
    eng.build_single_g()
    seed_net(eng.single_g, 9)
    seed_net(eng.encoder, 10)
    eng.feature_clusters = face_inputs(1, 16, 16, 7, 50, seed=8)[3]
    with torch_default_tf32():
        launches = stream_items(
            opt, eng, items, card, "face_stream_path",
            "edge2face 512x512 served: build_face_frame, --use_single_G (GlobalWithFeatures "
            "ngf64 + Encoder f32), then 1-scale ngf128 bf16", build_ms,
            dict(canny_ms=f"{canny_ms:.2f}", distance_maps_ms=f"{dist_ms:.2f}",
                 a_channels=items[0]["A"].shape[-1],
                 parts=",".join(map(str, np.unique(items[0]["inst"])))))
    n = n_items - opt.n_frames_G + 1
    want = dict.fromkeys(KERNELS, 0) | {"conv7": 4 * 2 + 5 * n, "respair": 9 * 2 + 18 * n,
                                        "warp_blend": n}
    if launches != want:
        raise AssertionError(f"face_stream launch counts {launches}, want {want}")
    return launches


def pose_stream_path(card: str) -> dict:
    """Phase 8d: pose2body 256p served through the test CLI's loop: each
    frame's 6 channels built by data/pose.py::pose_conditioning from a
    seeded DensePose IUV render and OpenPose people, centrally cropped to
    256x192 (the bodies' first run at a 32x24 grid), --no_first_img, bf16 at
    full width. Returns the launch counts."""
    opt = Options(**POSE_STREAM)
    (h, w), n_items = POSE_STREAM_HW, 8
    rng, gen = np.random.default_rng(0), np.random.default_rng(0)
    params = get_img_params(opt, (w, h), random.Random(0),
                            np.random.RandomState(0))
    if target_size(opt, params) != (w, h):
        raise AssertionError(f"pose resize to {target_size(opt, params)}: want {w}x{h}, kept")
    items, build_ms = [], []
    for t in range(n_items):
        cx, top, height = w / 2 + 2 * t, 8, h - 16
        iuv = densepose_iuv(rng, h, w, cx, top, height)
        people = [openpose_person(rng, cx, top, height)]
        rgb = face_image(rng, h, w, np.array([[cx - 10, top], [cx + 10, top + 30]]))
        t0 = time.perf_counter()
        a = pose.central_crop(pose.pose_conditioning(iuv, people, (w, h), opt, params, gen))
        b = pose.central_crop(pose.pose_image(rgb, opt, params))
        build_ms.append((time.perf_counter() - t0) * 1e3)
        items.append({"A": a, "B": b, "inst": None, "change_seq": t == 0,
                      "path": f"pose{t:02d}"})
    eng = seeded_engine(opt, DEV, seed=11)
    return stream_items(opt, eng, items, card, "pose_stream_path",
                        "pose2body 256p served: pose_conditioning (IUV + OpenPose), "
                        "--no_first_img, 1-scale ngf128 bf16", build_ms,
                        dict(a_channels=items[0]["A"].shape[-1]))


class PoseClips:
    """PoseDataset's training items built in memory by data/pose.py's array
    builders: clip 0 with DensePose's face parts (23, 24), clip 1 without;
    each item draws its crop from the dataset's generators, as PoseDataset
    does, and records its host build ms."""

    def __init__(self, opt: Options, raw_hw: tuple[int, int]):
        self.opt, (self.h, self.w) = opt, raw_hw
        self.seq_len_max = opt.n_frames_total + opt.n_frames_G - 1
        self.rng = random.Random(opt.seed)
        self.np_rng = np.random.RandomState(opt.seed)
        self.gen = np.random.default_rng(opt.seed)
        self.build_ms: list = []

    def __len__(self):
        return 2

    def __getitem__(self, i):
        opt, h, w = self.opt, self.h, self.w
        params = get_img_params(opt, (w, h), self.rng, self.np_rng)
        if target_size(opt, params) != (w, h):
            raise AssertionError(f"pose resize to {target_size(opt, params)}: want {w}x{h}")
        rng = np.random.default_rng(i)
        t0 = time.perf_counter()
        a_frames, b_frames = [], []
        for t in range(self.seq_len_max):
            cx, top, height = w / 2 + 3 * t, 40, h - 80
            iuv = densepose_iuv(rng, h, w, cx, top, height, face=i == 0)
            people = [openpose_person(rng, cx, top, height)]
            rgb = face_image(rng, h, w, np.array([[cx - 30, top], [cx + 30, top + 90]]))
            a_frames.append(pose.central_crop(
                pose.pose_conditioning(iuv, people, (w, h), opt, params, self.gen)))
            b_frames.append(pose.central_crop(pose.pose_image(rgb, opt, params)))
        self.build_ms.append((time.perf_counter() - t0) * 1e3 / self.seq_len_max)

        def nchw(frames):
            return np.ascontiguousarray(np.stack(frames).transpose(0, 3, 1, 2))

        return {"A": nchw(a_frames), "B": nchw(b_frames), "inst": None,
                "A_path": f"pose_clip{i}", "seq": i}


def pose_train_path(card: str) -> dict:
    """Phase 7c: pose2body 512p training with the face discriminator
    through train_cli.train on PoseClips, the training phase's seeded
    FlowEstimator as the flow: one epoch of two clips (3 chunks each), the
    face losses nonzero on the face clip and zero on the other, `latest`
    saved (net_D_f.pth with it) and restored bit for bit into a fresh
    Trainer; warp_blend_bwd's per-call and device ms at the 512x256
    recipe's shape measured again. Returns the epoch's launch counts."""
    root = tempfile.mkdtemp(prefix="chip_smoke_pose_train_")
    try:
        opt = Options(**POSE_TRAIN, checkpoints_dir=root)
        dataset = PoseClips(opt, POSE_TRAIN_RAW_HW)
        est = seeded_flow_estimator(DEV, seed=3, tf32_seen=[])
        clip_ms, chunk_ms, save_ms, clip_outs, chunk_outs = [], [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        with torch_default_tf32(), timed(Trainer, "train_clip", clip_ms, clip_outs), \
                timed(Trainer, "train_chunk", chunk_ms, chunk_outs), \
                timed(train_cli, "save_checkpoint", save_ms):
            reset_launches()
            t0 = time.perf_counter()
            trainer, state = train_cli.train(opt, dataset=dataset, flow_fn=est)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        if (len(clip_ms), len(chunk_ms), trainer.schedule.total_steps) != (2, 6, 6):
            raise AssertionError(f"{len(clip_ms)} clips, {len(chunk_ms)} chunks: want 2, 6")
        face_keys = ("G_f_GAN", "G_f_GAN_Feat", "D_f_real", "D_f_fake")
        per_chunk = [out[2] for out in chunk_outs]
        for k, losses in enumerate(per_chunk):
            if not all(math.isfinite(v) for v in losses.values()):
                raise AssertionError(f"chunk {k}: non-finite loss {losses}")
            found = k < 3  # clip 0 holds the face parts
            if any((losses[f] != 0) != found for f in face_keys):
                raise AssertionError(f"chunk {k}: face losses {[losses[f] for f in face_keys]}, "
                                     f"want {'nonzero' if found else 'zero'}")
        for name in ("warp_blend", "warp_blend_bwd", "flow_warp", "flow_warp_bwd",
                     "correlation"):
            if launches[name] == 0:
                raise AssertionError(f"pose_train: {name} never launched ({launches})")
        run_dir = os.path.join(root, opt.name)
        ckpt = sorted(f for f in os.listdir(run_dir) if f.endswith(".pth"))
        want_files = ["latest_net_D.pth", "latest_net_D_T0.pth", "latest_net_D_T1.pth",
                      "latest_net_D_f.pth", "latest_net_G0.pth", "latest_net_G1.pth",
                      "latest_optim.pth"]
        if ckpt != want_files:
            raise AssertionError(f"checkpoint files {ckpt}, want {want_files}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(run_dir, f)) for f in ckpt)
        fresh = Trainer(opt, flow_fn=est, device=DEV)
        fstate = fresh.init_state()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fstate, _ = restore_checkpoint(opt, fstate, fresh.schedule)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        want, got = train_state_tensors(trainer, state), train_state_tensors(fresh, fstate)
        differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        n_face = sum(k.startswith("D.netD_f.") for k in want)
        if differ or got.keys() != want.keys() or not n_face:
            raise AssertionError(f"restored state differs at {differ[:8]} ({len(differ)}); "
                                 f"{n_face} netD_f tensors")
        n_tensors = len(want)
        del trainer, state, fresh, fstate, est, want, got
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # warp_blend_bwd at the 512x256 recipe's shape, three times (PR 9's run
    # read 0.1547 ms a call, device 0.0508, where PR 8's read 0.0464 / 0.0259)
    shape, dtype, _ = BWD_PATH["warp_blend_bwd"]
    args = bwd_case("warp_blend_bwd", shape, dtype, torch.Generator().manual_seed(1))
    bwd = [call_and_device_ms(warp_blend_bwd, args, fills=True) for _ in range(3)]
    del args
    say("pose_train_path", config="pose2body 512p: 2 scales ngf128 f32, D 3 scales + D_f "
        "1 scale, FlowNet2 f32, 2 clips x 3 chunks of 512x448, latest saved once",
        train_s=f"{train_s:.2f}", ms_per_clip=",".join(f"{v:.1f}" for v in clip_ms),
        ms_per_chunk=",".join(f"{v:.1f}" for v in chunk_ms),
        ms_per_chunk_median=f"{statistics.median(chunk_ms):.2f}",
        host_build_ms_per_frame=",".join(f"{v:.1f}" for v in dataset.build_ms),
        face_losses=json.dumps([[round(c[f], 5) for f in face_keys] for c in per_chunk]),
        loss_G_total=",".join(f"{c['loss_G_total']:.5g}" for c in per_chunk),
        loss_D_total=",".join(f"{c['loss_D_total']:.5g}" for c in per_chunk),
        checkpoint_bytes=ckpt_bytes, save_s=f"{save_ms[0] / 1e3:.2f}",
        restore_s=f"{restore_s:.2f}", restored_tensors_bit_for_bit=n_tensors,
        of_them_netD_f=n_face,
        peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
        warp_blend_bwd_ms_per_call=",".join(f"{a:.4f}" for a, _ in bwd),
        warp_blend_bwd_device_ms=",".join(f"{d:.4f}" for _, d in bwd), card=repr(card))
    return launches


class PairDataset:
    """In-memory flow samples (pair (2, H, W, 3), flow (H, W, 2)), as the
    flow datasets yield them (the card's machine has no PIL)."""

    def __init__(self, pairs, flows):
        self.pairs, self.flows = pairs, flows

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        return self.pairs[i], self.flows[i]


def timed_steps(harness, pair, flow, n: int) -> list[float]:
    """ms of n training steps, each ended by torch.cuda.synchronize()."""
    ms = []
    for _ in range(n):
        t1 = time.perf_counter()
        harness.train_step(pair, flow)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return ms


def flow_train_fit(card: str) -> None:
    """Phase 9, fit: FlowNetC over two 2-sample in-memory datasets at 64x128
    for 2 epochs, saving in a temporary directory (removed after); both
    files exist; `best` restored into a fresh harness equals the best file
    bit for bit (weights and Adam state) and validates to the tracked best
    within 1e-3 relative."""
    pairs, flows = flow_pairs(4, 64, 128, seed=2)
    train_ds, val_ds = PairDataset(pairs[:2], flows[:2]), PairDataset(pairs[2:], flows[2:])
    tmp = tempfile.mkdtemp(prefix="flow_fit_")
    try:
        harness = FlowHarness(seeded_flownet_c(seed=4), device=DEV)
        with contextlib.redirect_stdout(io.StringIO()) as log:
            best = harness.fit(train_ds, val_ds, 2, save_dir=tmp, prefix="fit")
        files = sorted(os.listdir(tmp))
        if files != ["fit_checkpoint.pth.tar", "fit_model_best.pth.tar"]:
            raise AssertionError(f"fit wrote {files}")
        saved = torch.load(os.path.join(tmp, files[1]), map_location="cpu", weights_only=True)
        fresh = FlowHarness(seeded_flownet_c(seed=5), device=DEV)
        epoch, best2 = fresh.restore_checkpoint(tmp, prefix="fit", best=True)
        same = all(torch.equal(v.cpu(), saved["state_dict"][k])
                   for k, v in fresh.net.state_dict().items())
        opt_saved = [t for st in saved["optimizer"]["state"].values() for t in st.values()]
        opt_got = [t for st in fresh.optimizer.state_dict()["state"].values() for t in st.values()]
        same_opt = len(opt_got) == len(opt_saved) > 0 and all(
            torch.equal(a.cpu(), b) for a, b in zip(opt_got, opt_saved))
        val = fresh.validate(val_ds)
        if not (same and same_opt and best2 == best and math.isclose(val, best, rel_tol=1e-3)):
            raise AssertionError(f"fit restore: weights {same}, Adam {same_opt}, best {best2} "
                                 f"vs {best}, validate {val}")
        say("flow_fit", config="FlowNetC 64x128, 2 + 2 samples, 2 epochs", best_epe=f"{best:.5g}",
            best_epoch=epoch, validate_restored=f"{val:.5g}", files=",".join(files),
            restored_bit_for_bit=True, epochs=log.getvalue().count("epoch "), card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def flow_train_path(card: str) -> dict:
    """Phase 9: FlowNetC training through FlowHarness at batch 8 on 384x512
    pairs (the correlation at CORR_TRAIN_SHAPE), seeded weights, pairs from
    numpy seed 0: three warm-up and 5 timed steps in f32, then the same with
    mixed precision (bf16 forward, f32 masters); median ms a step, the peak
    memory, the launch counts (one correlation forward and one backward a
    step), the f32 convs without TF32; a profile of one f32 step by kernel
    family with the backward kernel's share; the casts around the
    correlation under bf16 timed beside its kernels; then `flow_train_fit`.
    Returns the launch counts of the 10 timed steps."""
    n_steps = 5
    pair, flow = flow_pairs(FLOW_TRAIN_BATCH, *FLOW_TRAIN_HW, seed=0)
    result, launches, tf32_seen = {}, {}, []
    for mode, mixed in (("f32", False), ("bf16", True)):
        net = seeded_flownet_c(seed=0)
        watch_tf32(tf32_seen, net)
        harness = FlowHarness(net, mixed_precision=mixed, device=DEV)
        with torch_default_tf32():
            # 3 warm-up steps: a bf16 step settles over its first few
            # (31.2, 27.5, then ~23 ms a step after one warm-up step on an
            # H100 80GB HBM3 at 700 W)
            timed_steps(harness, pair, flow, 3)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            ms = timed_steps(harness, pair, flow, n_steps)
            counted = read_launches()
            check_f32_convs(tf32_seen, "FlowNetC training")
            loss, err = harness.train_step(pair, flow)
            torch.cuda.synchronize()
        launches = {k: launches.get(k, 0) + v for k, v in counted.items()}
        want = dict.fromkeys(KERNELS, 0) | {"correlation": n_steps, "correlation_bwd": n_steps}
        if counted != want:
            raise AssertionError(f"{mode} steps: launch counts {counted}, want {want}")
        if not (math.isfinite(float(loss)) and math.isfinite(float(err))):
            raise AssertionError(f"{mode} step: loss {float(loss)}, EPE {float(err)}")
        if any(p.dtype != torch.float32 for p in harness.net.parameters()):
            raise AssertionError(f"{mode}: the master weights left f32")
        result[mode] = dict(ms=ms, peak=torch.cuda.max_memory_allocated(), loss=float(loss),
                            epe=float(err))
        if mode == "f32":
            with torch_default_tf32():
                families, busy_ms, prof_wall = profile_by_family(
                    lambda: harness.train_step(pair, flow), "one FlowNetC training step",
                    out_path("chip_smoke_profile_flow_train.txt"), DEV)
        del harness, net
        torch.cuda.empty_cache()
    fam = {f: ms for f, ms, _ in families}
    bwd_ms = fam.get("correlation backward (ours)", 0.0)
    med = {m: statistics.median(r["ms"]) for m, r in result.items()}
    say("flow_train_path", config="FlowNetC training, batch 8, 384x512 pairs",
        steps=n_steps, launches=json.dumps({k: v for k, v in launches.items() if v}),
        **{f"{m}_ms_per_step_median": f"{med[m]:.2f}" for m in result},
        **{f"{m}_ms_per_step": ",".join(f"{v:.1f}" for v in r["ms"]) for m, r in result.items()},
        **{f"{m}_peak_mem_gib": f"{r['peak'] / 2**30:.3f}" for m, r in result.items()},
        **{f"{m}_loss": f"{r['loss']:.5g}" for m, r in result.items()},
        **{f"{m}_epe": f"{r['epe']:.5g}" for m, r in result.items()},
        net_cudnn_allow_tf32=sorted(set(tf32_seen)), card=repr(card))
    say("flow_train_profile", profiled_step_wall_ms=f"{prof_wall:.2f}",
        kernel_ms=f"{busy_ms:.2f}", correlation_bwd_ms=f"{bwd_ms:.3f}",
        correlation_bwd_share_of_kernels=f"{bwd_ms / busy_ms:.4f}",
        correlation_bwd_share_of_step=f"{bwd_ms / prof_wall:.4f}",
        families=json.dumps({f: [round(ms, 3), n] for f, ms, n in families}))
    flow_train_casts()
    flow_train_fit(card)
    return launches


def flow_train_casts() -> None:
    """Phase 9: the f32 casts FlowNetC makes around the correlation kernels
    in a bf16 step at CORR_TRAIN_SHAPE (forward: the two operands to f32,
    the cost volume to bf16; backward: its cotangent to f32, the two
    gradients to bf16), timed beside the kernels at that shape."""
    gen = torch.Generator().manual_seed(9)
    f1, f2, g = corr_bwd_case(CORR_TRAIN_SHAPE, gen)
    f1_bf, f2_bf, g_bf = (t.bfloat16() for t in (f1, f2, g))

    def casts():
        f1_bf.float(), f2_bf.float(), g.bfloat16()  # forward
        g_bf.float(), f1.bfloat16(), f2.bfloat16()  # backward

    FLOW_TRAIN_CASTS.update(
        casts_ms=time_ms(casts, ()), forward_ms=time_ms(correlation, (f1, f2)),
        backward_ms=time_ms(correlation_bwd, (f1, f2, g)))
    say("flow_train_casts", shape="x".join(map(str, CORR_TRAIN_SHAPE)),
        **{k: f"{v:.4f}" for k, v in FLOW_TRAIN_CASTS.items()},
        casts_over_kernels=f"{FLOW_TRAIN_CASTS['casts_ms'] / (FLOW_TRAIN_CASTS['forward_ms'] + FLOW_TRAIN_CASTS['backward_ms']):.3f}")


def conv_workspace(nets, fn) -> int:
    """The largest transient allocation of any one cuDNN conv call (every
    nn.Conv2d and nn.ConvTranspose2d of the nets but the conv7 kernel's
    ReflectConv7) during fn(): the peak allocated inside the call beyond
    what was allocated before it and its output, which is cuDNN's
    workspace. Resets the peak counter."""
    worst = [0]

    def pre(mod, _):
        mod._v2v_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def post(mod, _, out):
        extra = torch.cuda.max_memory_allocated() - mod._v2v_before
        worst[0] = max(worst[0], extra - out.numel() * out.element_size())

    handles = []
    for net in nets:
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and not isinstance(
                    m, ReflectConv7):
                handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for handle in handles:
            handle.remove()
    return worst[0]


def seeding_memory(eng, seed_fn, frame_fn) -> dict:
    """Phase 8b's memory: the peak allocated over one seeding call and one
    streamed frame, and the largest cuDNN workspace of one conv call in
    them, under PyTorch's default TF32 flags (cuDNN's on: what the path
    runs under) and with TF32 off (the flags main() sets); GiB."""
    out = {}
    nets = (eng.single_g, eng.compute_generator())
    for flags, ctx in (("default_tf32", torch_default_tf32), ("tf32_off", contextlib.nullcontext)):
        with ctx():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            seed_fn()
            frame_fn()
            torch.cuda.synchronize()
            out[f"peak_gib_{flags}"] = f"{torch.cuda.max_memory_allocated() / 2**30:.3f}"
            out[f"resident_gib_{flags}"] = f"{base / 2**30:.3f}"
            ws = conv_workspace(nets, lambda: (seed_fn(), frame_fn()))
            out[f"cudnn_workspace_gib_{flags}"] = f"{ws / 2**30:.3f}"
    return out


def kernel_times(gen: torch.Generator) -> tuple[dict, dict]:
    """Phase 6: kernel, plain and library-call times at the paths' shapes.
    Returns {kernel: [ms, plain ms, library ms]} and {kernel: [bytes,
    operations]} per frame (label2city), per FlowEstimator call (FlowNet2)
    or per training chunk (the backward), as the JSON line states."""
    ms = {name: [0.0, 0.0, 0.0] for name in KERNELS}  # kernel, plain, library
    work = {name: [0.0, 0.0] for name in KERNELS}  # bytes, operations
    respair_times(gen, ms, work)
    warp_times(gen, ms, work)
    for i, shape in enumerate(CORR_SHAPES + [CORR_TRAIN_SHAPE]):
        args = corr_case(shape, gen)
        k, p = time_ms(correlation, args), time_ms(correlation_plain, args)
        b, c, h, w = shape
        flop = 2.0 * b * c * correlation_taps(h, w)  # one FMA a tap inside the image
        nb = (2 * c + 441) * b * h * w * 4
        if i == 0:
            ms["correlation"] = [k, p, None]
            work["correlation"] = [nb, flop]
        plan = correlation_plan(*shape, torch.cuda.get_device_properties(DEV)
                                .multi_processor_count)
        say("time", kernel="correlation", shape="x".join(map(str, shape)),
            dtype="float32", ms=f"{k:.4f}", plain_ms=f"{p:.4f}",
            tflops=f"{flop / k / 1e9:.2f}",
            share_of_ffma_bound=f"{bound_ms(nb, flop, F32_FLOPS)[0] / k:.3f}",
            f2_stagings_per_value=f"{f2_stagings(h, w):.3f}", split=plan.split,
            blocks=math.prod(plan.grid), calls_per_flow_call=int(i == 0))
        del args
    correlation_bwd_times(gen, ms, work)
    for name, (shape, dtype, n) in BWD_PATH.items():
        args = bwd_case(name, shape, dtype, gen)
        image, flow, g = (args[0], args[1], args[2]) if name == "flow_warp_bwd" else (
            args[1], args[2], args[4])
        # per call (events, the wrapper's host time included) and device
        # time (the profiler: kernels, the splat's memset, the cast)
        (k, k_dev), p = call_and_device_ms(KERNELS[name], args, fills=True), time_ms(
            PLAIN[name], args)
        lib, lib_dev = call_and_device_ms(grid_sample_backward(image, flow, g), (),
                                          fills=True)
        ms[name] = [n * k, n * p, n * lib]
        ms["warp_device"][name] = [n * k_dev, n * lib, n * lib_dev]
        # read g, image, flow [raw, w]; write dimage, dflow [d_raw, d_w]
        rw = (8, 5, 30) if name == "flow_warp_bwd" else (12, 9, 40)
        nb, nop = warp_work(shape, dtype, *rw)
        work[name] = [n * nb, n * nop]
        say("time", kernel=name, shape="x".join(map(str, shape)), dtype=str(dtype)[6:],
            ms_per_call=f"{k:.4f}", device_ms=f"{k_dev:.4f}", plain_ms=f"{p:.4f}",
            grid_sample_backward_ms_per_call=f"{lib:.4f}",
            grid_sample_backward_device_ms=f"{lib_dev:.4f}", calls_per_chunk=n)
        del args, image, flow, g
    for name, shape, dtype in BWD_CHECKS[2:]:  # the f32 backward at both sizes
        args = bwd_case(name, shape, dtype, gen)
        k, p = time_ms(KERNELS[name], args), time_ms(PLAIN[name], args)
        lib = time_ms(grid_sample_backward(*args), ())
        say("time", kernel=name, shape="x".join(map(str, shape)), dtype=str(dtype)[6:],
            ms=f"{k:.4f}", plain_ms=f"{p:.4f}", grid_sample_backward_ms=f"{lib:.4f}")
        del args
    conv_times(gen, ms, work)
    return ms, work


def corr_bwd_counts() -> dict:
    """Phase 6: the backward kernel's shared-memory reads against its FMAs,
    counted from its tile (csrc/correlation.cu's note). Per thread and f
    row: 21 steps of 4 rows x 8 channels x 4 pixels FMAs on 4 float4 G
    reads and one new window word a channel (3 more to start each window).
    Per warp: a G LDS.128 is broadcast over the 4 channel groups, 128
    distinct bytes (one wavefront; four if the card splits 128-bit loads by
    quarter warp), an F LDS.32 32 distinct words (one wavefront); an SM
    serves one wavefront a clock against 4 warp FMAs."""
    nd = 2 * KERNEL_RADIUS + 1
    fmas = nd * BWD_ROWS * BWD_THREAD_CHANNELS * 4
    g_loads, f_words = nd * BWD_ROWS, BWD_THREAD_CHANNELS * (nd + 3)
    return dict(fmas_per_thread_f_row=fmas,
                smem_words_per_thread_f_row=4 * g_loads + f_words,
                fmas_per_smem_word=round(fmas / (4 * g_loads + f_words), 3),
                wavefronts_per_warp_f_row=f"{g_loads + f_words}-{4 * g_loads + f_words}",
                fma_clocks_per_warp_f_row=fmas // 4)


def warp_times(gen: torch.Generator, ms: dict, work: dict) -> None:
    """Phase 6, the warp forwards at their path shapes on both flow kinds:
    per-call ms (events) and device ms (profiler) beside grid_sample's,
    alone and (the blend) followed by the blend in PyTorch, the plain
    version's ms, the bound and its share, and the share of tiles the plan
    stages (staged_tiles). The kernels' JSON rows keep the i.i.d. flow's
    numbers, their history's yardstick: ms["warp_device"] = {kernel:
    [device ms, grid_sample ms, its device ms, with the blend ms, device]};
    ms["warp_smooth"] the smooth flow's, per frame (3 blends, bf16) and per
    FlowEstimator call (5 warps, f32)."""
    ms["warp_device"] = {"warp_blend": [0.0] * 5, "flow_warp": [0.0] * 3}
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "library_with_blend_ms", "library_with_blend_device_ms", "bound_ms")
    ms["warp_smooth"] = {"warp_blend": dict.fromkeys(keys, 0.0),
                         "flow_warp": dict.fromkeys(keys[:5] + keys[-1:], 0.0)}
    for kind in WARP_FLOWS:
        for dtype in (torch.bfloat16, torch.float32):
            cases = [("warp_blend", (1, 3, h, w), 1) for h, w in WARP_SHAPES]
            cases.append(("flow_warp", FLOW_WARP_SHAPE, 5))
            for name, (b, c, h, w), n in cases:
                if name == "warp_blend":
                    raw, prev, flow, weight = args = warp_case(h, w, dtype, gen, b, c, kind)
                    nb, nop = warp_work((b, c, h, w), dtype, 9, 3, 12)
                else:
                    prev, flow = args = flow_warp_case(dtype, gen, (b, c, h, w), kind)
                    nb, nop = warp_work((b, c, h, w), dtype, 5, 3, 10)
                grid = sampling_grid(flow)
                (k, k_dev), p = call_and_device_ms(KERNELS[name], args), time_ms(PLAIN[name], args)
                lib, lib_dev = call_and_device_ms(grid_sample, (prev, grid))
                blend, blend_dev = (call_and_device_ms(grid_sample_blend, (raw, prev, grid, weight))
                                    if name == "warp_blend" else (None, None))
                b_ms, b_by = bound_ms(nb, nop, F32_FLOPS)
                plan = warp_forward_plan(c, dtype, h, w, w)
                tiles = b * math.ceil(h / plan.rows) * math.ceil(w / plan.cols)
                staged = staged_tiles(flow, plan, c)
                # the JSON rows: the flagship frame's bf16 blends, FlowNet2's f32 warps
                if (name, dtype) in (("warp_blend", torch.bfloat16), ("flow_warp", torch.float32)):
                    got = (k, k_dev, p, lib, lib_dev, blend, blend_dev, b_ms)
                    if kind == "iid":
                        for i, v in enumerate((k, p, lib)):
                            ms[name][i] += n * v
                        dev = ms["warp_device"][name]
                        for i, v in enumerate((k_dev, lib, lib_dev, blend, blend_dev)[:len(dev)]):
                            dev[i] += n * v
                        work[name][0] += n * nb
                        work[name][1] += n * nop
                    else:
                        for key, v in zip(keys, got):
                            if key in ms["warp_smooth"][name]:
                                ms["warp_smooth"][name][key] += n * v
                extra = {} if blend is None else dict(
                    grid_sample_blend_ms_per_call=f"{blend:.4f}",
                    grid_sample_blend_device_ms=f"{blend_dev:.4f}")
                say("time", kernel=name, flow=kind, shape="x".join(map(str, (b, c, h, w))),
                    dtype=str(dtype)[6:], ms_per_call=f"{k:.4f}", device_ms=f"{k_dev:.4f}",
                    plain_ms=f"{p:.4f}", grid_sample_ms_per_call=f"{lib:.4f}",
                    grid_sample_device_ms=f"{lib_dev:.4f}", **extra,
                    per_call_over_grid_sample=f"{k / lib:.3f}",
                    device_over_grid_sample=f"{k_dev / lib_dev:.3f}",
                    bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                    device_share_of_bound=f"{b_ms / k_dev:.3f}",
                    plan=f"{plan.rows}x{plan.cols}/{plan.smem_bytes}",
                    staged_share=f"{staged / tiles:.4f}",
                    **{"calls_per_frame" if name == "warp_blend" else "calls_per_flow_call": n})
                del args, prev, flow, grid
                raw = weight = None


def correlation_bwd_times(gen: torch.Generator, ms: dict, work: dict) -> None:
    """Phase 6: the backward at FlowNetC's training shape against the plain
    VJP (the autograd of correlation_plain), then at CORR_BWD_TIMED; its
    bound: one FMA per tap inside the image a gradient element (f1, f2 and
    g read once, df1 and df2 written once); its grid's blocks and waves,
    the FMAs it executes (f rows outside the image skipped, zero-filled
    pairs and columns computed) and its shared-memory reads per FMA."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    for i, shape in enumerate([CORR_TRAIN_SHAPE] + CORR_BWD_TIMED):
        args = corr_bwd_case(shape, gen)
        k = time_ms(correlation_bwd, args)
        p = time_ms(correlation_backward_plain, args) if i == 0 else None
        b, c, h, w = shape
        fmas = 2 * b * c * correlation_taps(h, w)  # both gradients
        flop, nb = 2.0 * fmas, (4 * c + 441) * b * h * w * 4
        b_ms, b_by = bound_ms(nb, flop, F32_FLOPS)
        if i == 0:
            ms["correlation_bwd"], work["correlation_bwd"] = [k, p, None], [nb, flop]
        blocks = math.prod(correlation_bwd_plan(*shape))
        executed = correlation_bwd_fmas(*shape)
        say("time", kernel="correlation_bwd", shape="x".join(map(str, shape)),
            dtype="float32", ms=f"{k:.4f}", plain_ms=None if p is None else f"{p:.4f}",
            tflops=f"{flop / k / 1e9:.2f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bytes_bound_ms=f"{nb / HBM_BPS * 1e3:.4f}", share_of_bound=f"{b_ms / k:.4f}",
            plain_over_kernel=None if p is None else f"{p / k:.1f}",
            blocks=blocks, sms=sms, blocks_per_sm=BWD_BLOCKS_PER_SM,
            waves=f"{blocks / (sms * BWD_BLOCKS_PER_SM):.3f}",
            fmas_needed=fmas, fmas_executed=executed,
            executed_over_needed_fmas=f"{executed / fmas:.4f}",
            executed_tflops=f"{2 * executed / k / 1e9:.2f}",
            calls_per_flow_train_step=int(i == 0), **(corr_bwd_counts() if i == 0 else {}))
        del args


def respair_work(c, h, w, size):
    """(bytes, operations) of one respair call: x read, out written, both
    weights read once; two 3x3 convs."""
    return (2 * c * h * w + 2 * 9 * c * c) * size, 2 * 2 * 9 * c * c * h * w


def f32_ab_ms(fn) -> dict:
    """The same-run A/B of the two f32 7x7 conv bodies on one call: each
    forced in turns (tensor cores, CUDA cores, CUDA cores, tensor cores),
    time_ms each time; {body: mean ms}."""
    got = {body: [] for body in BODIES}
    for body in ("tensor_cores", "cuda_cores", "cuda_cores", "tensor_cores"):
        with forced_conv7_body(BODIES[body]):
            got[body].append(time_ms(fn, ()))
    return {body: sum(v) / len(v) for body, v in got.items()}


def rule_name(code: int) -> str:
    return next(name for name, c in BODIES.items() if c == code)


def say_f32_ab(kernel: str, shape: str, path: str, n: int, ab: dict, rule: int,
               p: float, lib: float, nb: float, nop: float) -> float:
    """One phase-6 line of an f32 conv call: each body timed (both for a
    7x7, the tensor cores for a 3x3), the rule's pick, plain, cuDNN (TF32
    off), the FFMA and 3xTF32 bounds, TFLOP/s; returns the ms of the body
    the rule picks."""
    k = ab[rule_name(rule)]
    b_ffma, b_tc = bound_ms(nb, nop, F32_FLOPS)[0], bound_ms(nb, nop, TF32X3_FLOPS)[0]
    faster = min(ab, key=ab.get)
    bodies = {}
    for body, v in ab.items():
        bodies[f"{body}_ms"] = f"{v:.4f}"
        bodies[f"{body}_tflops"] = f"{nop / v / 1e9:.2f}"
    say("time", kernel=kernel, path=path, shape=shape, dtype="float32", **bodies,
        faster=faster, rule=rule_name(rule), rule_picks_faster=faster == rule_name(rule),
        ms=f"{k:.4f}", plain_ms=f"{p:.4f}", cudnn_ms=f"{lib:.4f}",
        bound_ms_3xtf32=f"{b_tc:.4f}", bound_ms_ffma=f"{b_ffma:.4f}",
        share_of_3xtf32_bound=f"{b_tc / k:.4f}", over_cudnn=f"{k / lib:.3f}", calls=n)
    return k


def add_f32(tot: dict, n: int, ab: dict, k, p, lib, nb, nop) -> None:
    for key, v in (("ms", k), ("plain", p), ("cudnn", lib), ("bytes", nb), ("ops", nop),
                   *ab.items()):
        tot[key] = tot.get(key, 0.0) + n * v


def say_f32_total(kernel: str, key: str, tot: dict, ms: dict, work: dict) -> None:
    """The summed line of an f32 conv over one seeding call of a path; the
    sums go into ms[key] ([ms, plain, library], then each timed body's:
    None where a body was not timed) and work[key]."""
    ms[key] = [tot["ms"], tot["plain"], tot["cudnn"], *(tot.get(b) for b in BODIES)]
    work[key] = [tot["bytes"], tot["ops"]]
    b_ffma = bound_ms(tot["bytes"], tot["ops"], F32_FLOPS)[0]
    b_tc = bound_ms(tot["bytes"], tot["ops"], TF32X3_FLOPS)[0]
    say("time", kernel=kernel, case=f"summed per {key.split()[-1]} seeding call",
        dtype="float32", ms=f"{tot['ms']:.3f}",
        **{f"{b}_ms": f"{tot[b]:.3f}" for b in BODIES if b in tot},
        plain_ms=f"{tot['plain']:.3f}",
        cudnn_ms=f"{tot['cudnn']:.3f}", bound_ms_3xtf32=f"{b_tc:.4f}",
        bound_ms_ffma=f"{b_ffma:.4f}", tflops=f"{tot['ops'] / tot['ms'] / 1e9:.2f}",
        share_of_3xtf32_bound=f"{b_tc / tot['ms']:.4f}",
        over_cudnn=f"{tot['ms'] / tot['cudnn']:.3f}")


def respair_times(gen: torch.Generator, ms: dict, work: dict) -> None:
    """Phase 6, respair: bf16 at the flagship frame's shapes (per 2048x1024
    frame, the kernel with the weights packed once, as ResnetBlock keeps
    them), for each shape ms, TFLOP/s, the share of the bound and the ratio
    to two cuDNN 3x3 convs (TF32 off); f32 at the single-image paths'
    shapes (per seeding call, weights packed once; 3xTF32 on the tensor
    cores, its only body) beside cuDNN, the FFMA and the 3xTF32 bound. Adds
    ms["respair_f32 <path>"], work["respair_f32 <path>"]."""
    tot = [0.0] * 6  # ms, plain, lib, bytes, ops, bound
    for c, h, w, n in RESPAIR_SHAPES:
        x, k0, ab0, k1, ab1 = args = respair_case(c, h, w, torch.bfloat16, gen)
        packed = (pack_conv3_weight(k0), pack_conv3_weight(k1))
        k = time_ms(lambda: respair(*args, packed=packed), ())
        p = time_ms(respair_plain, args)
        lib = time_ms(lambda: F.conv2d(F.conv2d(x, k0, padding=1), k1, padding=1), ())
        nb, nop = respair_work(c, h, w, x.element_size())
        b_ms = bound_ms(nb, nop, BF16_FLOPS)[0]
        for i, v in enumerate((k, p, lib, nb, nop, b_ms)):
            tot[i] += n * v
        say("time", kernel="respair", shape=f"{c}x{h}x{w}", dtype="bfloat16",
            ms=f"{k:.4f}", plain_ms=f"{p:.4f}", conv_pair_ms=f"{lib:.4f}",
            tflops=f"{nop / k / 1e9:.2f}", bound_ms=f"{b_ms:.4f}",
            share_of_bound=f"{b_ms / k:.4f}", over_conv_pair=f"{k / lib:.3f}",
            calls=n, per="2048x1024 frame")
        del args, x, k0, k1, packed
    k, p, lib, nb, nop, b_ms = tot
    ms["respair"], work["respair"] = [k, p, lib], [nb, nop]
    say("time", kernel="respair", case="summed per 2048x1024 frame", dtype="bfloat16",
        ms=f"{k:.3f}", plain_ms=f"{p:.3f}", conv_pair_ms=f"{lib:.3f}",
        bound_ms=f"{b_ms:.4f}", tflops=f"{nop / k / 1e9:.2f}",
        share_of_bound=f"{b_ms / k:.4f}", over_conv_pair=f"{k / lib:.3f}")
    totals = {}
    for c, h, w, n, path in RESPAIR_F32_SHAPES:
        x, k0, ab0, k1, ab1 = args = respair_case(c, h, w, torch.float32, gen)
        packed = (pack_for_kernel(k0), pack_for_kernel(k1))
        ab = {"tensor_cores": time_ms(lambda: respair(*args, packed=packed), ())}
        p = time_ms(respair_plain, args)
        lib = time_ms(lambda: F.conv2d(F.conv2d(x, k0, padding=1), k1, padding=1), ())
        nb, nop = respair_work(c, h, w, 4)
        k = say_f32_ab("respair", f"{c}x{h}x{w}", path, n, ab, TENSOR_CORES, p, lib, nb,
                       nop)
        add_f32(totals.setdefault(path, {}), n, ab, k, p, lib, nb, nop)
        del args, x, k0, k1, packed
    for path, tot_f32 in totals.items():
        say_f32_total("respair", f"respair_f32 {path}", tot_f32, ms, work)


def conv7_work(ci, co, h, w, size):
    """(bytes, operations) of a 7x7 conv: input, weights, bias, output."""
    return (ci * h * w + co * h * w + 49 * ci * co) * size + 4 * co, 98.0 * ci * co * h * w


def composite_conv7_times(gen: torch.Generator, ms: dict, work: dict) -> None:
    """Phase 6, conv7 in bf16 at the flagship composite's 21 7x7 convs per
    2048x1024 frame (the label2city path's): per shape the kernel as the
    composite calls it (weights packed once; the tensor-core body,
    csrc/conv_wgmma.cuh, the only bf16 one), its plain version, cuDNN on the
    pre-padded input, TFLOP/s and the share of the bound; summed per frame
    into ms["conv7_bf16"], work["conv7_bf16"]."""
    tot = dict.fromkeys(("ms", "plain", "cudnn", "bound", "bytes", "ops"), 0.0)
    for ci, co, h, w in COMPOSITE_CONV7:
        x, wt, bias = args = conv7_case(ci, co, h, w, torch.bfloat16, gen)
        packed = pack_conv7_weight(wt)
        xp = F.pad(x, (3, 3, 3, 3), mode="reflect")
        k = time_ms(lambda: conv7_reflect(x, wt, bias, packed=packed), ())
        p = time_ms(conv7_reflect_plain, args)
        lib = time_ms(F.conv2d, (xp, wt, bias.bfloat16()))
        nb, nop = conv7_work(ci, co, h, w, 2)
        b_ms = bound_ms(nb, nop, BF16_FLOPS)[0]
        for key, v in (("ms", k), ("plain", p), ("cudnn", lib), ("bound", b_ms),
                       ("bytes", nb), ("ops", nop)):
            tot[key] += v
        say("time", kernel="conv7", path="label2city (the composite)",
            shape=f"{ci}->{co}x{h}x{w}", dtype="bfloat16", ms=f"{k:.4f}",
            conv2d_ms=f"{lib:.4f}", plain_ms=f"{p:.4f}", tflops=f"{nop / k / 1e9:.2f}",
            bound_ms=f"{b_ms:.4f}", share_of_bound=f"{b_ms / k:.4f}",
            over_cudnn=f"{k / lib:.3f}", body="tensor cores (conv_wgmma.cuh)")
        del args, x, xp, wt, packed
    ms["conv7_bf16"] = [tot["ms"], tot["plain"], tot["cudnn"]]
    work["conv7_bf16"] = [tot["bytes"], tot["ops"]]
    say("time", kernel="conv7", case="the flagship composite's 21 7x7 convs per "
        "2048x1024 frame", dtype="bfloat16", ms=f"{tot['ms']:.3f}",
        conv2d_ms=f"{tot['cudnn']:.3f}", plain_ms=f"{tot['plain']:.3f}",
        bound_ms=f"{tot['bound']:.4f}", tflops=f"{tot['ops'] / tot['ms'] / 1e9:.2f}",
        share_of_bound=f"{tot['bound'] / tot['ms']:.4f}",
        kernel_over_cudnn=f"{tot['ms'] / tot['cudnn']:.3f}")


def conv_times(gen: torch.Generator, ms: dict, work: dict) -> None:
    """Phase 6, the conv kernels: conv7 at the single-image nets' shapes in
    f32, both bodies in turns (f32_ab_ms), per seeding call of each path
    (ms["conv7_f32 <path>"]; ms["conv7"]: per edge2face first frame, as the
    kernels' JSON states) and at the flagship composite's 7x7 shapes in
    bf16 (composite_conv7_times); conv3 and conv3_fused at the label2city
    path's 3x3 convs in bf16 (per 2048x1024 frame). Library: F.conv2d on
    the pre-padded input."""
    for path, shapes in CONV7_SHAPES.items():
        tot = {}
        for net, ci, co, h, w in shapes:
            x, wt, bias = args = conv7_case(ci, co, h, w, torch.float32, gen)
            xp = F.pad(x, (3, 3, 3, 3), mode="reflect")
            packed = pack_for_kernel(wt)
            ab = f32_ab_ms(lambda: conv7_reflect(x, wt, bias, packed=packed))
            p = time_ms(conv7_reflect_plain, args)
            lib = time_ms(F.conv2d, (xp, wt, bias))
            nb, nop = conv7_work(ci, co, h, w, 4)
            k = say_f32_ab("conv7", f"{net}: {ci}->{co}x{h}x{w}", path, 2, ab,
                           conv7_body(torch.float32, ci, co), p, lib, nb, nop)
            add_f32(tot, 2, ab, k, p, lib, nb, nop)  # two frames a seeding call
            del args, x, xp, wt, packed
        say_f32_total("conv7", f"conv7_f32 {path}", tot, ms, work)
    ms["conv7"] = [v / 2 for v in ms["conv7_f32 edge2face_single"][:3]]
    work["conv7"] = [v / 2 for v in work["conv7_f32 edge2face_single"]]
    composite_conv7_times(gen, ms, work)
    for name in ("conv3", "conv3_fused"):
        ms[name], work[name] = [0.0, 0.0, 0.0], [0.0, 0.0]
    for c, h, w, n in RESPAIR_SHAPES:
        (xp, k0), relu_args, res_args = conv3_cases(c, h, w, torch.bfloat16, gen)
        lib = time_ms(F.conv2d, (xp, k0))
        conv_bytes = (c * (h + 2) * (w + 2) + c * h * w + 9 * c * c) * 2
        conv_ops = 2.0 * 9 * c * c * h * w
        k, p = time_ms(conv3_padded, (xp, k0)), time_ms(conv3_plain, (xp, k0))
        for i, v in enumerate((k, p, lib)):
            ms["conv3"][i] += 2 * n * v
        work["conv3"][0] += 2 * n * conv_bytes
        work["conv3"][1] += 2 * n * conv_ops
        fused = [(time_ms(conv3_fused_padded, a), time_ms(conv3_fused_plain, a))
                 for a in (relu_args, res_args)]
        for i in range(2):
            ms["conv3_fused"][i] += n * (fused[0][i] + fused[1][i])
        ms["conv3_fused"][2] += 2 * n * lib
        work["conv3_fused"][0] += n * (2 * conv_bytes + c * h * w * 2)  # + the residual
        work["conv3_fused"][1] += 2 * n * conv_ops
        b_ms = bound_ms(conv_bytes, conv_ops, BF16_FLOPS)[0]
        b_res = bound_ms(conv_bytes + c * h * w * 2, conv_ops, BF16_FLOPS)[0]
        say("time", kernel="conv3", shape=f"{c}x{h}x{w}", dtype="bfloat16", ms=f"{k:.4f}",
            plain_ms=f"{p:.4f}", conv2d_ms=f"{lib:.4f}", tflops=f"{conv_ops / k / 1e9:.2f}",
            share_of_bound=f"{b_ms / k:.4f}", over_conv2d=f"{k / lib:.3f}",
            calls_per_frame=2 * n)
        say("time", kernel="conv3_fused", shape=f"{c}x{h}x{w}", dtype="bfloat16",
            relu_ms=f"{fused[0][0]:.4f}", relu_plain_ms=f"{fused[0][1]:.4f}",
            residual_ms=f"{fused[1][0]:.4f}", residual_plain_ms=f"{fused[1][1]:.4f}",
            conv2d_ms=f"{lib:.4f}", relu_tflops=f"{conv_ops / fused[0][0] / 1e9:.2f}",
            residual_tflops=f"{conv_ops / fused[1][0] / 1e9:.2f}",
            relu_share_of_bound=f"{b_ms / fused[0][0]:.4f}",
            residual_share_of_bound=f"{b_res / fused[1][0]:.4f}",
            relu_over_conv2d=f"{fused[0][0] / lib:.3f}",
            residual_over_conv2d=f"{fused[1][0] / lib:.3f}", calls_per_frame=f"{n}+{n}")
        del xp, k0, relu_args, res_args
    for name in ("conv3", "conv3_fused"):
        k, _, lib = ms[name]
        b_ms = bound_ms(*work[name], BF16_FLOPS)[0]
        say("time", kernel=name, case="summed over the 90 3x3 convs of one 2048x1024 frame",
            dtype="bfloat16", ms=f"{k:.3f}", conv2d_ms=f"{lib:.3f}", bound_ms=f"{b_ms:.4f}",
            tflops=f"{work[name][1] / k / 1e9:.2f}", share_of_bound=f"{b_ms / k:.4f}",
            over_conv2d=f"{k / lib:.3f}")


def f32_block(name: str, path: str, ms: dict, work: dict) -> dict:
    """The kernels' JSON block of an f32 conv on a single-image path, per
    seeding call (2 frames): the body the rule picks (ms) and each timed
    body (null where not timed: respair's CUDA cores), plain, cuDNN (TF32
    off), the 3xTF32 bound and the FFMA bound."""
    key = f"{name}_f32 {path}"
    b_ms, b_by = bound_ms(*work[key], TF32X3_FLOPS)
    return dict(
        zip(("ms", "plain_ms", "library_ms", "ms_tensor_cores", "ms_cuda_cores"), ms[key]),
        bound_ms=b_ms, bound_by=b_by, bound_ms_ffma=bound_ms(*work[key], F32_FLOPS)[0],
        tflops=work[key][1] / ms[key][0] / 1e9, launches_in_seeding=SEED_LAUNCHES[path][name],
        ms_is="f32, summed per seeding call (2 frames), each call on the body its rule "
              "picks; bound: 3xTF32 on the tensor cores; library: cuDNN f32, TF32 off")


def kernels_json(errs: dict, ms: dict, work: dict, launches: dict) -> list:
    """The kernels' JSON entries."""
    kernels = []
    sources = {
        "respair": ("vid2vid_tpu_torch/csrc/respair.cu",
                    "vid2vid_tpu/ops/respair_pallas.py:79", "label2city", BF16_FLOPS,
                    "bf16, summed over one 2048x1024 label2city frame's 45 calls; "
                    "library: two cuDNN 3x3 convs (zero padding)"),
        "warp_blend": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                       "vid2vid_tpu/ops/warp.py:271", "label2city", F32_FLOPS,
                       "bf16, summed over one 2048x1024 label2city frame's 3 calls, on "
                       "an i.i.d. flow of 8 px a pixel (smooth_flow: the same on a smooth "
                       "flow, tools/warp_plans.py::smooth_flow); ms: "
                       "per call (events over 200 back-to-back calls, the wrapper "
                       "included), device_ms: the profiler's kernel time; library: "
                       "F.grid_sample alone, without the blend, timed both ways"),
        "flow_warp": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                      "vid2vid_tpu/ops/warp.py:271", "flownet2", F32_FLOPS,
                      "f32, summed over one FlowEstimator call's 5 launches at "
                      "(2, 3, 1024, 2048), flows and smooth_flow as warp_blend's; ms per "
                      "call and device_ms as warp_blend's; library: F.grid_sample"),
        "correlation": ("vid2vid_tpu_torch/csrc/correlation.cu",
                        "vid2vid_tpu/ops/correlation_pallas.py:35", "flownet2", F32_FLOPS,
                        "f32, one FlowEstimator call's one launch at "
                        "(2, 256, 128, 256), on register tiles of 4 rows x 2 "
                        "pixels x 21 dx, f2 rows shared along diagonals, cp.async "
                        "double buffering, the channel sum split where the grid is "
                        "under one wave; bound: FFMA, one FMA per tap inside the "
                        "image; no library call computes it"),
        "correlation_bwd": ("vid2vid_tpu_torch/csrc/correlation.cu",
                            "vid2vid_tpu/ops/correlation.py:25", "flow_train", F32_FLOPS,
                            "f32, one FlowNetC training step's one launch at "
                            "(8, 256, 48, 64) (batch 8 of 384x512 pairs): the VJP of the "
                            "cost volume on register tiles of 4 rows x 4 pixels x 8 "
                            "channels, f rows shared along diagonals, cp.async double "
                            "buffering, no atomics; replaces the autograd of "
                            "correlation_plain (plain_ms), as JAX differentiates "
                            "correlation_ref; bound: FFMA, one FMA per tap inside the "
                            "image a gradient element; no library call computes it"),
        "warp_blend_bwd": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                           "vid2vid_tpu/ops/warp.py:300", "training", F32_FLOPS,
                           "bf16, summed over one 512x256 training chunk's 2 calls at "
                           "(1, 3, 256, 512); ms: per call (events over 200 "
                           "back-to-back calls, the wrapper included: one ctypes "
                           "call, which zeroes and casts the splat itself), "
                           "device_ms: the profiler's kernels, memsets and fills, "
                           "on bwd_case's independent 8 px flows; library: F.grid_sample's backward alone, timed both ways"),
        "flow_warp_bwd": ("vid2vid_tpu_torch/csrc/warp_blend.cu",
                          "vid2vid_tpu/ops/warp.py:300", "training", F32_FLOPS,
                          "f32, one 512x256 training chunk's F_Warp call at "
                          "(2, 3, 256, 512); ms per call and device_ms as "
                          "warp_blend_bwd's; library: F.grid_sample's backward"),
        "conv7": ("vid2vid_tpu_torch/csrc/conv.cu", "vid2vid_tpu/ops/conv7_pallas.py:52",
                  "edge2face_single", TF32X3_FLOPS,
                  "f32, summed over one 512x512 edge2face single-image frame's 4 "
                  "calls (G stem 31->64, G head 80->3, E stem 3->16, E head 16->16), "
                  "each on the body conv7_body picks; bound: 3xTF32 on the tensor "
                  "cores (bound_ms_ffma: FFMA); library: F.conv2d on the pre-padded "
                  "input; launches: the path's in both dtypes (its stream's "
                  "composite runs bf16 conv7); f32: per seeding call of each path"),
        "conv7_bf16": ("vid2vid_tpu_torch/csrc/conv_wgmma.cuh",
                       "vid2vid_tpu/ops/conv7_pallas.py:52", "label2city", BF16_FLOPS,
                       "bf16, summed over the 21 7x7 stems and heads of one 2048x1024 "
                       "label2city frame's composite, weights packed once; library: "
                       "cuDNN (F.conv2d on the pre-padded input); launches: the "
                       "conv7 counter's on each path"),
        "conv3": ("vid2vid_tpu_torch/csrc/conv.cu", "vid2vid_tpu/ops/conv3_pallas.py:65",
                  None, BF16_FLOPS,
                  "bf16, summed over the 90 3x3 stride-1 convs of one 2048x1024 "
                  "label2city frame (2 per respair call), which the path runs through "
                  "respair: no path calls conv3, as in the JAX package; library: "
                  "F.conv2d on the pre-padded input"),
        "conv3_fused": ("vid2vid_tpu_torch/csrc/conv.cu",
                        "vid2vid_tpu/ops/conv3_pallas.py:146", None, BF16_FLOPS,
                        "bf16, the same 90 convs with respair's epilogues (45 ReLU, 45 "
                        "residual); no path calls it, as in the JAX package; library: "
                        "F.conv2d alone"),
    }
    for name, (src, rep, path, peak_ops, ms_is) in sources.items():
        b_ms, b_by = bound_ms(work[name][0], work[name][1], peak_ops)
        counter = "conv7" if name == "conv7_bf16" else name
        dtype_err = torch.bfloat16 if name == "conv7_bf16" else torch.float32
        extra = {}
        if name in ms["warp_device"]:
            extra.update(zip(("device_ms", "library_ms_per_call", "library_device_ms",
                              "library_with_blend_ms_per_call",
                              "library_with_blend_device_ms"), ms["warp_device"][name]))
        if name in ms["warp_smooth"]:
            extra["smooth_flow"] = ms["warp_smooth"][name]
        if name in ("respair", "conv7"):  # the f32 calls: per seeding call
            extra["f32"] = {p: f32_block(name, p, ms, work)
                            for p in ("edge2face_single", "label2city_single")}
        if name == "correlation":
            extra["bf16_casts_flow_train"] = dict(
                FLOW_TRAIN_CASTS, shape=list(CORR_TRAIN_SHAPE),
                ms_is="per bf16 FlowNetC training step: the f32 casts of the two "
                      "operands and the cost volume's cast back (forward), the "
                      "cotangent's and the two gradients' (backward), beside the "
                      "kernels at that shape")
        if name in ("respair", "conv7_bf16", "warp_blend"):  # phase 13, bf16
            extra["halo_mode_ms"] = HALO_MS.get(name.split("_bf16")[0])
        if name == "conv7":
            extra["max_abs_err_f32_other_body"] = OTHER_BODY_ERRS.get(name)
            extra["bound_ms_ffma"] = bound_ms(*work[name], F32_FLOPS)[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[path][counter] if path else 0,
            "launches_by_path": {p: launches[p][counter] for p in launches},
            "max_abs_err": errs[counter][dtype_err],
            "max_abs_err_bf16": errs[counter].get(torch.bfloat16),
            "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": ms[name][2], "ms_is": ms_is, **extra,
        })
    # the warp backward at a column offset (phase 14): its own row, from
    # that phase's checks and times
    at = SHARD_BWD[torch.bfloat16]
    b_ms, b_by = bound_ms(at["bytes"], at["ops"], F32_FLOPS)
    kernels.append({
        "name": "warp_blend_at_bwd", "route": "cuda",
        "source": "vid2vid_tpu_torch/csrc/warp_blend.cu", "replaces": "vid2vid_tpu/ops/warp.py:300",
        "launches": SHARD_BWD["launches"],
        "launches_by_path": {p: launches[p]["warp_blend_bwd"] for p in launches},
        "max_abs_err": SHARD_BWD[torch.float32]["max_abs_err"],
        "max_abs_err_bf16": at["max_abs_err"],
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": at["library_ms"], "ms_unsharded_call": at["ms_unsharded"],
        "ms_is": f"bf16, v2v_warp_blend_bwd at a column offset: the {SHARD_TRAIN_RANKS} shards' "
                 f"calls at {SHARD_BWD_SHAPE} summed (each over the whole previous frame), "
                 "events per call; ms_unsharded_call: the unsharded entry on the whole frame; "
                 "library: F.grid_sample's backward at each shard's grid, summed; launches: "
                 "the two ranks' counted run of phase 14 (launches_by_path: the "
                 "warp_blend_bwd counter, both entries)",
    })
    # the loss engine's unfused warp and its backward at a column offset
    # (phase 14): rows of their own, from that phase's checks and times
    for entry, counter, replaces, what in (
            ("flow_warp_at", "flow_warp", "vid2vid_tpu/ops/warp.py:271",
             "v2v_flow_warp_at: F_Warp's and G_Warp's forward; library: F.grid_sample at "
             "each shard's grid"),
            ("flow_warp_at_bwd", "flow_warp_bwd", "vid2vid_tpu/ops/warp.py:300",
             "v2v_flow_warp_at_bwd: F_Warp's backward (d_flow at the shard's columns, "
             "d_image over the whole frame); library: F.grid_sample's backward at each "
             "shard's grid")):
        row = SHARD_WARP[entry]
        b_ms, b_by = bound_ms(row["bytes"], row["ops"], F32_FLOPS)
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "vid2vid_tpu_torch/csrc/warp_blend.cu", "replaces": replaces,
            "launches": SHARD_WARP[entry + "_launches"],
            "launches_by_path": {p: launches[p][counter] for p in launches},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": row["library_ms"], "ms_unsharded_call": row["ms_unsharded"],
            "ms_is": f"f32, {what}: the {SHARD_TRAIN_RANKS} shards' calls at {SHARD_WARP_SHAPE} "
                     "summed, events per call; bound: the image's pixels the samples reach "
                     "(measured from the flow), the shard's flow and output (and the whole "
                     "d_image the backward writes); "
                     "ms_unsharded_call: the unsharded entry on the whole frame; launches: "
                     f"the two ranks' counted run of phase 14 (launches_by_path: the "
                     f"{counter} counter, both entries)",
        })
    # FlowNetC's correlation in its column-halo mode (phase 14): its own row
    row = SHARD_CORR
    b_ms, b_by = bound_ms(row["bytes"], row["ops"], F32_FLOPS)
    kernels.append({
        "name": "correlation_halo", "route": "cuda",
        "source": "vid2vid_tpu_torch/csrc/correlation.cu",
        "replaces": "vid2vid_tpu/ops/correlation_pallas.py:35",
        "launches": row["launches"],
        "launches_by_path": {p: launches[p]["correlation"] for p in launches},
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "ms_unsharded_call": row["ms_unsharded"],
        "ms_is": f"f32, v2v_correlation_cols: the {SHARD_TRAIN_RANKS} shards' calls at "
                 f"{SHARD_CORR_SHAPE} summed (each f2 40 columns wider), events per call; "
                 "bound: FFMA, one FMA a tap inside the whole image (a neighbour's column "
                 "counts), f1's and the output's columns and f2's padded row once; "
                 "ms_unsharded_call: v2v_correlation on the whole tensor; no library call "
                 "computes it; launches: the two ranks' counted run of phase 14 "
                 "(launches_by_path: the correlation counter, both entries)",
    })
    return kernels


def main() -> None:
    t_run = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = smi()

    # 1. device
    say("device", kind=repr(kind), smi=repr(card), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # 2. build
    build_phase()

    gen = torch.Generator().manual_seed(0)
    errs = check_kernels(gen)
    torch.cuda.empty_cache()
    reference_generator()
    reference_flow()
    reference_training()
    reference_single_g()
    reference_flow_train()
    launches, path_s = {}, {"before_paths": time.perf_counter() - t_run}
    for path, run in (("label2city", label2city_path),
                      ("label2city_clip", label2city_clip_path),
                      ("flownet2", flownet2_path),
                      ("training", training_path), ("train_cli", train_cli_path),
                      ("edge2face_single", edge2face_single_path),
                      ("label2city_single", label2city_single_path),
                      ("face_stream", face_stream_path), ("pose_stream", pose_stream_path),
                      ("pose_train", pose_train_path), ("flow_train", flow_train_path),
                      ("export", export_path), ("ledger", ledger_path),
                      ("ddp_train", ddp_train_path), ("shard_serve", shard_serve_path),
                      ("shard_train", shard_train_path)):
        t_path = time.perf_counter()
        with kernel_call_shapes() as seen:
            launches[path] = (run(card, seen)
                              if path in ("ddp_train", "shard_serve", "shard_train")
                              else run(card))
        torch.cuda.empty_cache()
        check_path_shapes(path, seen, errs, gen)
        torch.cuda.empty_cache()
        path_s[path] = time.perf_counter() - t_path
        say("path_seconds", path=path, seconds=f"{path_s[path]:.1f}")
    ms, work = kernel_times(gen)
    path_s["kernel_times"] = time.perf_counter() - t_run - sum(path_s.values())
    say("run_seconds", seconds=f"{time.perf_counter() - t_run:.1f}",
        by_part=json.dumps({k: round(v, 1) for k, v in path_s.items()}),
        limit_s=1200, card=repr(card))
    print(json.dumps({"kernels": kernels_json(errs, ms, work, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
