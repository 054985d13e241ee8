"""``repro_torch.index`` — the wide-query executor over stacked slabs."""

from repro_torch.index.engine import (And, AndNot, Expr, Leaf, Or, SlabLeaf,
                                      and_, andnot, batched_and_card,
                                      execute, execute_card, launch_model,
                                      leaf, or_, topk_by_card)

__all__ = ["Expr", "Leaf", "SlabLeaf", "And", "Or", "AndNot", "leaf",
           "and_", "or_", "andnot", "execute", "execute_card",
           "batched_and_card", "topk_by_card", "launch_model"]
