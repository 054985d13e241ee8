"""stablelm-3b [dense] — 32 heads with kv=32.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50_304,
    layer_pattern="dense",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="stablelm-3b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    layer_pattern="dense",
)
