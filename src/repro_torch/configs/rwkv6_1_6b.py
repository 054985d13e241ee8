"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]

The paper's roaring-sparse-attention technique is INAPPLICABLE to this
attention-free architecture (DESIGN.md S5); roaring gradient compression and
the bitmap-indexed data pipeline still apply. long_500k runs natively (O(1)
state per token).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,                      # d / 64 notional (rwkv head size 64)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    layer_pattern="rwkv",
    tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-reduced",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, vocab=512,
    layer_pattern="rwkv", tie_embeddings=False,
)
