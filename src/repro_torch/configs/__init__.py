"""Architecture registry: ``--arch <id>`` resolves here.

The port serves the attention-only archs whose decode runs through the
paged KV cache; every other arch of the reference registry waits for a
later slice (ROADMAP queue 1) and raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from .base import SHAPES, ShapeSpec

ARCHS = {
    "gemma2-2b": "gemma2_2b",
    "stablelm-1.6b": "stablelm_1_6b",
}


def get_config(arch: str, reduced: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet (ported: "
                       f"{', '.join(ARCHS)}); see ROADMAP.md queue 1")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def list_archs():
    return list(ARCHS)


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "list_archs"]
