"""``repro_torch.index`` — the wide-query executor over stacked slabs."""

from repro_torch.index.engine import (And, AndNot, CompiledQuery, Expr, Leaf,
                                      Or, SlabLeaf, and_, andnot,
                                      batched_and_card,
                                      batched_and_card_sharded, compile_query,
                                      execute, execute_card, launch_model,
                                      leaf, or_, topk_by_card,
                                      topk_by_card_sharded,
                                      union_many_batched, wide_intersect,
                                      wide_union)

__all__ = ["Expr", "Leaf", "SlabLeaf", "And", "Or", "AndNot", "leaf",
           "and_", "or_", "andnot", "CompiledQuery", "compile_query",
           "execute", "execute_card", "wide_union",
           "wide_intersect", "batched_and_card", "batched_and_card_sharded",
           "topk_by_card", "topk_by_card_sharded",
           "union_many_batched", "launch_model"]
