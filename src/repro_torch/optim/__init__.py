"""Optimizer substrate of the port: AdamW, LR schedules, gradient
compression (counterparts of ``repro.optim``)."""
from .adamw import AdamW, OptState
from .compression import topk_compress_with_feedback
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup_cosine",
           "topk_compress_with_feedback"]
