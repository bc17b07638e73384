"""zamba2-7b [hybrid] — Mamba2 backbone + SHARED attention blocks.
[arXiv:2411.15242; unverified]

The JAX package's configuration (``repro/configs/zamba2_7b.py``), copied:
81 layers = 13 groups of [5 mamba2 + 1 shared-weight attention block] + 3
trailing mamba2 layers.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, activation="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, hybrid_every=6,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2411.15242; unverified",
)

REDUCED = FULL.replace(
    n_layers=13, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=384, vocab=512, ssm_state=16, ssm_head_dim=32, hybrid_every=4,
    ssm_chunk=32, param_dtype="float32", compute_dtype="float32",
)
