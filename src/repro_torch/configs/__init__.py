"""Config registry: ``get_config(arch_id)`` and the assigned-architecture list.

A copy of ``repro.configs`` (plain data, no jax), so that the port reads the
same ten configurations without importing the JAX package.
"""
from .base import ModelConfig
from .shapes import SHAPES, ShapeSpec, applicable

from .musicgen_large import CONFIG as _musicgen_large
from .gemma2_9b import CONFIG as _gemma2_9b
from .internlm2_1_8b import CONFIG as _internlm2_1_8b
from .minitron_4b import CONFIG as _minitron_4b
from .mistral_large_123b import CONFIG as _mistral_large_123b
from .zamba2_2_7b import CONFIG as _zamba2_2_7b
from .dbrx_132b import CONFIG as _dbrx_132b
from .qwen2_moe_a2_7b import CONFIG as _qwen2_moe_a2_7b
from .rwkv6_3b import CONFIG as _rwkv6_3b
from .chameleon_34b import CONFIG as _chameleon_34b

ARCHS: dict[str, ModelConfig] = {
    "musicgen-large": _musicgen_large,
    "gemma2-9b": _gemma2_9b,
    "internlm2-1.8b": _internlm2_1_8b,
    "minitron-4b": _minitron_4b,
    "mistral-large-123b": _mistral_large_123b,
    "zamba2-2.7b": _zamba2_2_7b,
    "dbrx-132b": _dbrx_132b,
    "qwen2-moe-a2.7b": _qwen2_moe_a2_7b,
    "rwkv6-3b": _rwkv6_3b,
    "chameleon-34b": _chameleon_34b,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ShapeSpec", "applicable", "get_config"]
