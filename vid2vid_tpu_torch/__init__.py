"""vid2vid_tpu_torch — the PyTorch / CUDA port of vid2vid_tpu for NVIDIA Hopper.

It keeps the JAX package's layout and names, so each module's counterpart
is found by path:
  config    — Options and the reference's flags (a copy of the JAX
              package's config.py)
  ops/      — encoding, pyramids, resize, channel norm, the flow warp (alone
              and with the temporal blend, forward and backward), the
              residual block and the FlowNetC correlation; the last four
              launch hand-written CUDA kernels on a CUDA tensor
  csrc/     — the CUDA C++ sources of those kernels (sm_90a)
  kernels/  — nvcc build at first use, ctypes loading
  nn/       — the composite generators, the PatchGAN discriminators and
              VGG19 as torch.nn modules with the reference's state-dict
              names (NCHW)
  models/   — the scale-stacked generator, the streaming inference engine,
              the temporal bookkeeping, the GAN loss engine, and flownet2/:
              the FlowNet2 reference-flow stack and its standalone CLI
  train/    — the training schedule, optimizers, steps and loop
  data/     — the test-time stream and the synthetic training clip
  utils/    — the name mappings, weights carried across from the JAX
              package, and the device rule
  test_cli  — the streaming inference CLI

It imports torch and never jax, and nothing of the JAX package: the
modules it needs from there (config, the name mappings) are its own copies.
Entry points run on the first CUDA device unless the caller asks for the
CPU (`utils/device.py`).
"""

__version__ = "0.1.0"
