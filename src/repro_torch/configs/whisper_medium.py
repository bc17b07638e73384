"""whisper-medium [audio] — enc-dec; conv frontend is a STUB (the caller
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]

The JAX package's configuration (``repro/configs/whisper_medium.py``),
copied: 24 encoder and 24 decoder layers, sinusoidal positions on the
encoder's 1500 frames, a learned position table on the decoder, the
token embedding tied to the head.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865, activation="gelu",
    use_rope=False, enc_len=1500, max_positions=32768, tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2212.04356; unverified",
)

REDUCED = FULL.replace(
    n_layers=3, n_enc_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, enc_len=64, max_positions=256,
    param_dtype="float32", compute_dtype="float32",
)
