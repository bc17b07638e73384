"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution; vision tower is a STUB
(the caller provides patch embeddings). [arXiv:2409.12191; hf]

The JAX package's configuration (``repro/configs/qwen2_vl_72b.py``),
copied: the rotary pairs of a head split (16, 24, 24) over the (t, h, w)
position streams, and 1024 patch embeddings lead the text.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, qkv_bias=True, activation="swiglu",
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    n_vision_tokens=1024,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2409.12191; hf",
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab=512, mrope_sections=(4, 6, 6), n_vision_tokens=16,
    param_dtype="float32", compute_dtype="float32",
)
