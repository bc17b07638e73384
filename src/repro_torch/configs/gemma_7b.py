"""gemma-7b [dense] — MHA(16kv), GeGLU, head_dim=256. [arXiv:2403.08295; hf]

The JAX package's configuration (``repro/configs/gemma_7b.py``), copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, activation="geglu",
    norm_plus_one=True, embed_scale=True, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2403.08295; hf",
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=512, vocab=512, param_dtype="float32", compute_dtype="float32",
)
