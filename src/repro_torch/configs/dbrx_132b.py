"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base;
unverified]

The JAX package's configuration (``repro/configs/dbrx_132b.py``), copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, activation="swiglu",
    n_experts=16, top_k=4, d_ff_expert=10752, rope_theta=500_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:databricks/dbrx-base; unverified",
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, n_experts=4, top_k=2, d_ff_expert=256, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
