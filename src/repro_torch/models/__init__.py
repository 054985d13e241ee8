"""``repro_torch.models`` — the LM for attention-only patterns (gemma2,
stablelm), with decode against the Roaring-paged KV cache."""
