"""``repro_torch.store`` — the host-side posting builders the search index
uses (the columnar store itself is not ported yet)."""
