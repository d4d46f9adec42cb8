"""The served kernels as dispatchable operators, namespace `v2v`.

    torch.ops.v2v.respair(x, k0, a0, c0, k1, a1, c1, packed0, packed1)
    torch.ops.v2v.conv7(x, w, bias, packed, reflect)
    torch.ops.v2v.warp_blend(raw, prev, flow, weight)

Each has a CUDA implementation (the hand-written kernel's ctypes launch,
which counts the launch), a CPU implementation (the plain version) and a
fake one (an empty tensor of the output's shape, dtype and device), so
that `torch.export` can trace a model that calls them and a loaded
artifact calls the kernels again (tools/export.py). The dispatcher picks
the implementation from the operands' device. The wrappers `ops.respair.
respair`, `ops.conv7.conv7_reflect` / `conv7_padded` and `ops.warp.
warp_blend` are the only callers: they check the shapes, carry the
gradient (their autograd.Functions, whose forward calls the operator too)
and fold optional arguments into the schema. No operator returns a view of
an input.

The operators are defined with `torch.library.Library(.., "DEF")` and
per-device `impl`s, which dispatch in C++ (`torch.library.custom_op` adds
a layer of Python to every call). Each module defines its operator when it
is imported; `served_ops()` imports the three.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

NAMESPACE = "v2v"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define `v2v::<name><schema>` with its CPU, CUDA and fake
    implementations; returns the operator."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")

    def traced(*args):
        # register_fake also installs this as the Meta kernel: a real meta
        # tensor is neither a trace nor a device the operator runs on
        if args[0].device.type == "meta":
            raise ValueError(f"{name}: device meta is not CUDA (the operator takes CPU "
                             "and CUDA tensors)")
        return fake(*args)

    torch.library.register_fake(f"{NAMESPACE}::{name}", traced, lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def served_ops() -> dict[str, torch._ops.OpOverload]:
    """The three operators by name, their modules imported (which defines
    them): what a loaded artifact calls."""
    from vid2vid_tpu_torch.ops import conv7, respair, warp

    return {"respair": respair.RESPAIR_OP, "conv7": conv7.CONV7_OP,
            "warp_blend": warp.WARP_BLEND_OP}
