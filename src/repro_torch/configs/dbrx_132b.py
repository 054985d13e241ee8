"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE on every layer.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100_352,
    layer_pattern="moe",
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="dbrx-132b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    layer_pattern="moe", n_experts=4, top_k=2,
)
