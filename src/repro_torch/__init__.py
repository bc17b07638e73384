"""PyTorch/CUDA port of the ESDP reproduction (the JAX package ``repro``
is the reference it is held against).

Layout mirrors ``repro``: ``core`` holds instances, statistics, the
budgeted DP, policies and the slot simulator; ``kernels`` holds the
hand-written CUDA kernels with their plain PyTorch versions.  Entry
points take ``device=None``, which means ``"cuda"`` — with no card they
raise rather than fall back; the CPU runs only when asked for
(``device="cpu"``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
