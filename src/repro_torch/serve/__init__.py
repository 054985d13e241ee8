"""``repro_torch.serve`` — continuous-batching LM serving over the
Roaring-paged KV cache."""

from .engine import Request, ServeEngine
from .kv_cache import PagedKVCache, RoaringPageTable

__all__ = ["RoaringPageTable", "PagedKVCache", "ServeEngine", "Request"]
