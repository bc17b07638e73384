"""gemma3-27b [dense] — GQA(16kv), 5 local : 1 global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

The JAX package's configuration (``repro/configs/gemma3_27b.py``), copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144, activation="geglu",
    global_every=6, window=1024, rope_theta=10_000.0,
    norm_plus_one=True, embed_scale=True, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="hf:google/gemma-3-1b-pt; unverified",
)

REDUCED = FULL.replace(
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab=512, window=64,
    param_dtype="float32", compute_dtype="float32",
)
