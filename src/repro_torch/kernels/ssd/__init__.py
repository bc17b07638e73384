"""Mamba2 SSD chunked scan (K7) for Hopper, forward and backward, with
their plain PyTorch versions (``ref``)."""
from .kernel import (BWD_HEAD_GROUP, BWD_KERNELS, BWD_LAUNCHES_PER_CALL,
                     BWD_LIBRARY, KERNELS, LAUNCHES, LIBRARY, Q_MAX,
                     bwd_shares, bwd_work, scan_work, smem_bytes, ssd_bwd,
                     ssd_scan, ssd_scan_saved)
from .ops import SsdFn, ssd_op
from .ref import ssd_bwd_ref, ssd_ref

__all__ = ["BWD_HEAD_GROUP", "BWD_KERNELS", "BWD_LAUNCHES_PER_CALL",
           "BWD_LIBRARY", "KERNELS", "LAUNCHES", "LIBRARY", "Q_MAX", "SsdFn",
           "bwd_shares", "bwd_work", "scan_work", "smem_bytes", "ssd_bwd",
           "ssd_bwd_ref",
           "ssd_scan", "ssd_scan_saved", "ssd_op", "ssd_ref"]
