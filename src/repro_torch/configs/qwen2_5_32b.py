"""qwen2.5-32b [dense] — GQA(8kv), QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

The JAX package's configuration (``repro/configs/qwen2_5_32b.py``), copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab=152064, qkv_bias=True, activation="swiglu",
    rope_theta=1_000_000.0, param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=384, vocab=512, param_dtype="float32", compute_dtype="float32",
)
