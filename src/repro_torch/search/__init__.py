"""``repro_torch.search`` — the batched inverted-index query service."""

from repro_torch.search.index import PostingIndex
from repro_torch.search.loadgen import (LoadStats, gen_zipf_postings,
                                        percentile, run_closed_loop,
                                        zipf_queries)
from repro_torch.search.service import (And, AndNot, Or, SearchService, Term,
                                        and_, andnot, or_, term)

__all__ = ["PostingIndex", "SearchService", "Term", "And", "Or", "AndNot",
           "term", "and_", "or_", "andnot", "LoadStats", "gen_zipf_postings",
           "zipf_queries", "run_closed_loop", "percentile"]
