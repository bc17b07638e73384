"""Architecture registry: ``get_config(arch_id, reduced=False)``.

The port has the hybrid family (zamba2-7b) so far; every other
architecture of the JAX package raises ``NotImplementedError``.
"""
from . import zamba2_7b
from .base import SHAPES, ModelConfig, Shape, shape_applicable

_MODULES = {"zamba2-7b": zamba2_7b}

# the JAX package's registry; the port serves those in _MODULES
ARCHS = ("qwen2.5-32b", "gemma3-27b", "gemma-7b", "qwen1.5-32b", "zamba2-7b",
         "dbrx-132b", "deepseek-v3-671b", "whisper-medium", "mamba2-2.7b",
         "qwen2-vl-72b")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet (ROADMAP.md, Queue 1 "
            f"items 12-13); ported: {tuple(_MODULES)}")
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.FULL


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "Shape", "get_config",
           "shape_applicable"]
