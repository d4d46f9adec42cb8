"""vid2vid_tpu_torch — the PyTorch / CUDA port of vid2vid_tpu for NVIDIA Hopper.

It keeps the JAX package's layout and names, so each module's counterpart
is found by path:
  ops/      — encoding, pyramids, resize, channel norm, the flow warp (alone
              and with the temporal blend), the residual block and the
              FlowNetC correlation; the last four launch hand-written CUDA
              kernels on a CUDA tensor
  csrc/     — the CUDA C++ sources of those kernels (sm_90a)
  kernels/  — nvcc build at first use, ctypes loading
  nn/       — the composite generators as torch.nn modules with the
              reference's state-dict names (NCHW)
  models/   — the scale-stacked generator, the streaming inference engine,
              and flownet2/: the FlowNet2 reference-flow stack and its
              standalone inference CLI
  utils/    — weights carried across from the JAX package
  test_cli  — the streaming inference CLI

It imports torch and never jax; from the JAX package it uses only the
jax-free `config` (Options) and `utils/torch_import` (name mappings).
"""

__version__ = "0.1.0"
