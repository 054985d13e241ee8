"""``repro_torch.distributed`` — the launcher's declared mesh (``context``)
and the logical sharding rules over ``torch.distributed`` device meshes
(``sharding``)."""

from repro_torch.distributed import context, sharding

__all__ = ["context", "sharding"]
