"""Architecture registry: ``get_config(arch_id, reduced=False)``.

Every arch of the JAX package's registry: the dense family (gemma-7b,
gemma3-27b, qwen1.5-32b, qwen2.5-32b), the moe family (dbrx-132b, and
deepseek-v3-671b with MLA), the ssm family (mamba2-2.7b), the hybrid
family (zamba2-7b), the vlm family (qwen2-vl-72b, M-RoPE) and the encdec
family (whisper-medium).  ``ARCHS`` is that shipped tuple; ``_MODULES``
also takes configs registered at run time (``examples/train_tiny_lm.py``
registers its "tiny-100m" there), which ``get_config`` and the drivers
accept.
"""
from . import (dbrx_132b, deepseek_v3_671b, gemma3_27b, gemma_7b,
               mamba2_2_7b, qwen1_5_32b, qwen2_5_32b, qwen2_vl_72b,
               whisper_medium, zamba2_7b)
from .base import SHAPES, ModelConfig, Shape, shape_applicable

_MODULES = {"qwen2.5-32b": qwen2_5_32b, "gemma3-27b": gemma3_27b,
            "gemma-7b": gemma_7b, "qwen1.5-32b": qwen1_5_32b,
            "zamba2-7b": zamba2_7b, "dbrx-132b": dbrx_132b,
            "deepseek-v3-671b": deepseek_v3_671b, "mamba2-2.7b": mamba2_2_7b,
            "qwen2-vl-72b": qwen2_vl_72b, "whisper-medium": whisper_medium}

# the JAX package's registry, in its order; the port serves all of it
ARCHS = ("qwen2.5-32b", "gemma3-27b", "gemma-7b", "qwen1.5-32b", "zamba2-7b",
         "dbrx-132b", "deepseek-v3-671b", "whisper-medium", "mamba2-2.7b",
         "qwen2-vl-72b")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    """The FULL or REDUCED config of ``arch``: a shipped arch or one a
    caller registered at run time in ``_MODULES`` (any object with FULL
    and REDUCED), as the JAX package's registry takes them.  Raises
    ``KeyError`` for a name in neither."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{tuple(_MODULES)}")
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.FULL


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "Shape", "get_config",
           "shape_applicable"]
