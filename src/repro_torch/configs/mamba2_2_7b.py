"""mamba2-2.7b [ssm] — attention-free SSD. [arXiv:2405.21060; unverified]

The JAX package's configuration (``repro/configs/mamba2_2_7b.py``), copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2405.21060; unverified",
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, vocab=512, ssm_state=16, ssm_head_dim=32,
    ssm_chunk=32, param_dtype="float32", compute_dtype="float32",
)
