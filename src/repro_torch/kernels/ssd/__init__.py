"""Mamba2 SSD chunked scan (K7) for Hopper, with its plain PyTorch version
(``ref``)."""
from .kernel import KERNELS, LAUNCHES, LIBRARY, Q_MAX, smem_bytes, ssd_scan
from .ops import ssd_op
from .ref import ssd_ref

__all__ = ["KERNELS", "LAUNCHES", "LIBRARY", "Q_MAX", "smem_bytes",
           "ssd_scan", "ssd_op", "ssd_ref"]
