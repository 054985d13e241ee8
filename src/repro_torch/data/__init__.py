"""``repro_torch.data`` — the bitmap-indexed data pipeline."""

from .pipeline import (SyntheticCorpus, BitmapIndex, DataPipeline,
                       PipelineState)

__all__ = ["SyntheticCorpus", "BitmapIndex", "DataPipeline", "PipelineState"]
