"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256_000,
    head_dim=256,
    layer_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
# 26 layers = 13 local/global super-blocks; sqrt(d) embedding scaling is
# enabled via logit_softcap (gemma family convention).

REDUCED = ModelConfig(
    name="gemma2-2b-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, layer_pattern="local_global", window=64,
    attn_softcap=50.0, logit_softcap=30.0,
)
