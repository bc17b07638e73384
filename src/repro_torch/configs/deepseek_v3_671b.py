"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]

The JAX package's configuration (``repro/configs/deepseek_v3_671b.py``),
copied.
"""
from .base import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    vocab=129280, activation="swiglu",
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    nope_head_dim=128, rope_head_dim=64, v_head_dim=128,
    d_ff=18432,  # the 3 leading dense layers
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    moe_layer_start=3, mtp=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    source="arXiv:2412.19437; hf",
)

REDUCED = FULL.replace(
    n_layers=5, d_model=128, n_heads=4,
    q_lora_rank=48, kv_lora_rank=32, nope_head_dim=16, rope_head_dim=8,
    v_head_dim=16, d_ff=384, n_experts=8, top_k=2, d_ff_expert=64,
    moe_layer_start=2, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
