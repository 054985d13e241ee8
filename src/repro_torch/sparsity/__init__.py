"""``repro_torch.sparsity`` — Roaring block masks for sparse attention."""

from .masks import (MaskBuilder, build_arch_mask, compile_mask,
                    local_window_mask, global_stripe_mask, causal_mask,
                    doc_boundary_mask, mask_density, rows_to_slabs,
                    mask_overlap_cards, mask_jaccard)

__all__ = ["MaskBuilder", "build_arch_mask", "compile_mask",
           "local_window_mask", "global_stripe_mask", "causal_mask",
           "doc_boundary_mask", "mask_density", "rows_to_slabs",
           "mask_overlap_cards", "mask_jaccard"]
