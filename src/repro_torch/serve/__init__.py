"""``repro_torch.serve`` — continuous-batching LM serving over the
Roaring-paged KV cache."""

from .engine import Request, ServeEngine
from .kv_cache import RoaringPageTable

__all__ = ["RoaringPageTable", "ServeEngine", "Request"]
