"""Model configuration + input-shape registry (the JAX package's
``repro/configs/base.py``, copied: the port imports nothing from it)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "Shape", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One dataclass covers all 10 assigned families; unused fields stay None.

    Weights are stored flattened-2D wherever possible ((in, out) matrices),
    as in the JAX package.
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    use_rope: bool = True  # whisper uses absolute positions instead
    rope_theta: float = 10_000.0
    # sliding-window pattern: every `global_every`-th layer is global, rest
    # local with window `window` (gemma3's 5:1); 0 ⇒ all global.
    global_every: int = 0
    window: int = 0
    # M-RoPE (qwen2-vl): sizes of the (t, h, w) rotary sections (pairs).
    mrope_sections: Optional[tuple[int, int, int]] = None

    # --- MLA (deepseek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    nope_head_dim: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ---
    d_ff: int = 0
    activation: str = "swiglu"  # swiglu | geglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_layer_start: int = 0  # deepseek: first k layers stay dense
    capacity_factor: float = 1.0
    # combine strategy (§Perf P5): "gather" reshards ye to expert-unsharded
    # then scatters locally (wire ≈ k·Tg·d — wins for small E/k, e.g. dbrx);
    # "scatter_ar" scatters expert-sharded partials and all-reduces
    # (wire ≈ 2·Tg·d — wins for large E/k, e.g. deepseek's 256/8).
    moe_combine: str = "gather"

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # hybrid (zamba2): one SHARED attention block every `hybrid_every` layers
    hybrid_every: int = 0

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 0  # fixed encoder length (1500 = 30s audio)
    max_positions: int = 0  # learned positional table size (whisper)

    # --- blocking knobs (memory/compute trade; §Perf levers) ---
    attn_chunk: int = 1024  # KV-chunk for online-softmax attention
    xent_chunk: int = 2048  # seq-chunk for the cross-entropy (0=full)
    # cost-model support: unroll layer scans so cost_analysis counts every
    # layer (XLA counts while bodies once; see launch/cost_model.py)
    unroll_scans: bool = False

    # --- misc ---
    norm_eps: float = 1e-6
    norm_plus_one: bool = False  # gemma-style (1 + w) RMSNorm
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False
    mtp: bool = False  # deepseek multi-token prediction head
    n_vision_tokens: int = 0  # vlm: leading patch-embedding positions
    source: str = ""  # provenance tag from the assignment table

    # dtypes (dry-run realism for the giant configs; smoke tests use f32)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? SSM/hybrid only."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode



SHAPES: dict[str, Shape] = {
    "train_4k":    Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k":   Shape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(config: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped): long_500k needs sub-quadratic
    attention."""
    if shape.name == "long_500k" and not config.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{config.name} is full-attention (family={config.family})")
    return True, ""
