"""starcoder2-15b [dense] — GQA kv=4, RoPE, GPT-style (non-gated) MLP.
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49_152,
    layer_pattern="dense",
    rope_theta=100_000.0,
    gated_mlp=False,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="starcoder2-15b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    layer_pattern="dense", gated_mlp=False,
)
