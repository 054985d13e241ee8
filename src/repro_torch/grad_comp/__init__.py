"""``repro_torch.grad_comp`` — Roaring top-k gradient compression and the
compressed cross-pod gradient mean over ``torch.distributed``."""

from repro_torch.grad_comp.topk_roaring import (compress_leaf,
                                                compress_tree,
                                                compressed_crosspod_mean,
                                                compression_ratio,
                                                decompress_leaf,
                                                decompress_tree,
                                                leaf_jaccard, leaf_overlap,
                                                leaf_overlap_many,
                                                leaf_topk_overlap)

__all__ = ["compress_leaf", "decompress_leaf", "compress_tree",
           "decompress_tree", "compressed_crosspod_mean", "compression_ratio",
           "leaf_overlap", "leaf_jaccard", "leaf_overlap_many",
           "leaf_topk_overlap"]
