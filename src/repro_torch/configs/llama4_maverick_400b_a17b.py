"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, alternating
dense/MoE layers; early-fusion multimodal (text path here; the fusion
embeddings arrive via input_specs like the other frontend stubs).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    layer_pattern="moe_alt",        # dense / MoE alternation
    n_experts=128,
    top_k=1,
    rope_theta=500_000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="llama4-maverick-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    layer_pattern="moe_alt", n_experts=8, top_k=1, tie_embeddings=False,
)
