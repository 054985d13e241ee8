"""Architecture registry: ``--arch <id>`` resolves here.

The reference registry's ten architectures. Attention-only patterns serve
through the Roaring-paged KV cache (``serve.ServeEngine``); the others
(jamba's Mamba hybrid, RWKV6) decode through ``models.transformer.
decode_step`` over state caches.
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ShapeSpec

ARCHS = {
    "gemma2-2b": "gemma2_2b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-1.6b": "stablelm_1_6b",
    "stablelm-3b": "stablelm_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-base": "whisper_base",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def get_config(arch: str, reduced: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def list_archs():
    return list(ARCHS)


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "list_archs"]
