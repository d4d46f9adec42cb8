"""Device kernels by family: a frozen copy of the program's table
(vid2vid_tpu_torch/utils/profiling.py::FAMILIES), so that a later change
to the program cannot move the yardstick. The first pattern that matches
the lowercased kernel name wins."""

from __future__ import annotations

import re

FAMILIES = [
    # conv_wgmma_kernel<F32, 3, BN, RW, REFLECT, CL> (csrc/conv_wgmma.cuh,
    # bf16 and f32): respair's launches are the reflect ones
    ("respair (ours)", r"conv_wgmma_kernel<\w+, 3, \d+, \d+, true,"),
    ("conv7 (ours)", r"conv7x7_kernel<|conv_wgmma_kernel<\w+, 7,"),
    ("conv3 / conv3_fused (ours)", r"conv_wgmma_kernel<\w+, 3, \d+, \d+, false,"),
    ("warp kernels (ours)", r"warp_kernel|warp_bwd_kernel|splat_to_bf16_kernel"),
    ("correlation backward (ours)", r"correlation_bwd_kernel"),
    ("correlation (ours)", r"correlation_kernel|sum_parts_kernel"),
    ("memset (the warp backward's splat, others)", r"^memset"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"conv|cudnn|gemm|xmma|wgrad|dgrad|fprop|cutlass|winograd|implicit"),
    ("batch norm", r"batch_norm|batchnorm|bn_"),
    ("optimizer (Adam)", r"adam|multi_tensor"),
    ("reductions", r"reduce"),
    ("pool / resize", r"pool|upsample|grid_sampler|interpolate"),
    ("elementwise / copy / cat", r"elementwise|vectorized|copy|cat|fill|index|gather|scatter"),
]


def family(kernel_name: str) -> str:
    """The family of a device kernel's (or memcpy's, memset's) name, or
    "other"."""
    name = kernel_name.lower()
    return next((f for f, pattern in FAMILIES if re.search(pattern, name)), "other")
