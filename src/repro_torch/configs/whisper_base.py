"""whisper-base [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed 2x-downsampled frame embeddings).
[arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6,                      # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    layer_pattern="encdec",
    frontend="audio",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="whisper-base-reduced",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, layer_pattern="encdec", frontend="audio",
)
