"""Device selection shared by the port's constructors and entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. With no
    card present, ``None`` raises instead of silently building on the CPU:
    pass ``device="cpu"`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
