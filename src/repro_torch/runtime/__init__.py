"""Serving runtime of the port."""
from .serve_step import greedy_generate, make_decode_step, make_prefill_step

__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step"]
