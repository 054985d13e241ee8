"""jamba-1.5-large-398b [hybrid] — Mamba + attention 7:1 interleave, MoE 16e
top-2 on alternate layers. [arXiv:2403.19887; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65_536,
    layer_pattern="jamba",          # 9 super-blocks of (7 mamba + 1 attn)
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    layer_pattern="jamba", n_experts=4, top_k=2, ssm_state=4, ssm_conv=4,
    ssm_expand=2,
)
