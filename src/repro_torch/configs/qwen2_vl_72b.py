"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution vision (STUB frontend:
input_specs provides precomputed patch embeddings). [arXiv:2409.12191; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152_064,
    layer_pattern="dense",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w frequency split of head_dim/2 = 64
    frontend="vision",
    tie_embeddings=False,
    param_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, layer_pattern="dense", mrope_sections=(2, 3, 3),
    frontend="vision", tie_embeddings=False,
)
