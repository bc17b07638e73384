"""The hand-written kernels as ``torch.library`` operators, and their work
for counting modes.

Each kernel wrapper allocates its outputs and scratch and calls an
operator ``torch.ops.repro_torch.<name>`` that fills them: on the CPU the
plain version, on the card the kernel, on the meta device (and under
``FakeTensorMode``) nothing.  Defined with the plain ``torch.library``
API, a Python kernel the dispatcher calls directly: the wrappers of
``torch.library.custom_op`` (autograd, in-place and aliasing checks) add
host time to every call, and a Mamba2 training step makes 192.

Each operator also carries its work, (operations, bytes), from its
arguments: the operations as multiply-adds × 2 at the widths of the
function computed (the numbers ``chip_smoke.py`` divides for the
kernels' bounds), the bytes as each input read once and each output
written once.  ``FlopCounterMode`` counts the operations for the
operator — on the card, the meta device and the CPU alike, where the
plain version's own arithmetic runs below it and is not counted.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["KERNEL_WORK", "kernel_op"]

_LIB = torch.library.Library("repro_torch", "FRAGMENT")

# operator overload packet -> fn(*op_args) -> (operations, bytes)
KERNEL_WORK: dict = {}


def _nothing(*args):
    return None


def kernel_op(schema: str, impl: Callable, work: Callable):
    """Define ``repro_torch::<name>`` by ``schema`` (its mutable arguments
    marked ``(a!)``, returning ``()``): ``impl`` on CPU and CUDA tensors,
    nothing on meta and fake ones, ``work(*args)`` its (operations,
    bytes).  Returns the operator's overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)
    # the fake kernel serves the meta device too
    torch.library.register_fake(f"repro_torch::{name}", _nothing, lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    KERNEL_WORK[packet] = work

    def flops(*args, out_val=None, **kwargs):
        return work(*args, **kwargs)[0]
    register_flop_formula(packet, get_raw=True)(flops)
    return packet.default
