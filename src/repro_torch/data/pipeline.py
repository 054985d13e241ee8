"""Bitmap-indexed data pipeline — the paper's native workload, serving tokens.

A corpus of documents carries categorical attributes (language, quality
bucket, length bucket, dedup cluster). Each attribute value is indexed as a
paper-faithful RoaringBitmap over document ids; a training *mixture query*
(e.g. ``lang:en AND quality>=3 AND NOT dedup_dup``) is evaluated with Roaring
AND/OR/ANDNOT — milliseconds over millions of docs, with exact cardinalities
for mixture accounting.

The port runs the same numpy and the port's own ``py_roaring``, so it
produces the reference's token batches exactly.

Determinism + fault tolerance: the pipeline state is (epoch, cursor, the
selection bitmap's query string, permutation seed). Restoring the state
replays the same batches; the selection bitmap is re-derived from the query
so checkpoints stay small.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.py_roaring import RoaringBitmap


# =============================================================================
# synthetic corpus (documents + attributes + tokens)
# =============================================================================

class SyntheticCorpus:
    """Deterministic synthetic corpus: doc i reproducibly generates tokens and
    attributes from (seed, i) without storing the whole corpus."""

    def __init__(self, n_docs: int, vocab: int, seed: int = 0,
                 mean_len: int = 512):
        self.n_docs = n_docs
        self.vocab = vocab
        self.seed = seed
        self.mean_len = mean_len
        rng = np.random.default_rng(seed)
        self.lang = rng.integers(0, 8, n_docs).astype(np.int32)
        self.quality = rng.integers(0, 5, n_docs).astype(np.int32)
        self.length_bucket = rng.integers(0, 4, n_docs).astype(np.int32)
        self.dedup_dup = rng.random(n_docs) < 0.08

    def tokens(self, doc_id: int, max_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ doc_id)
        ln = max(8, int(rng.poisson(self.mean_len)))
        ln = min(ln, max_len)
        # zipf-like unigram structure (low ids frequent) so LMs have a
        # learnable signal; uniform tokens pin the loss at ln(vocab)
        frac = rng.beta(0.5, 4.0, ln)
        return np.clip((frac * self.vocab).astype(np.int32), 1,
                       self.vocab - 1)


class BitmapIndex:
    """Attribute -> value -> RoaringBitmap of doc ids."""

    def __init__(self, corpus: SyntheticCorpus):
        self.corpus = corpus
        self.index: Dict[str, Dict[int, RoaringBitmap]] = {}
        doc_ids = np.arange(corpus.n_docs, dtype=np.int64)
        for attr in ("lang", "quality", "length_bucket"):
            vals = getattr(corpus, attr)
            self.index[attr] = {
                int(v): RoaringBitmap.from_sorted_unique(doc_ids[vals == v])
                for v in np.unique(vals)}
        self.index["dedup_dup"] = {
            1: RoaringBitmap.from_sorted_unique(doc_ids[corpus.dedup_dup])}

    def bitmap(self, attr: str, value: int) -> RoaringBitmap:
        rb = self.index.get(attr, {}).get(int(value))
        if rb is None:
            return RoaringBitmap()
        return rb

    def query(self, spec: str) -> RoaringBitmap:
        """Tiny query language: 'lang=1&quality>=3&!dedup_dup' or
        'lang=1|lang=2'. & binds over |; ! negates one attribute."""
        universe = RoaringBitmap.from_sorted_unique(
            np.arange(self.corpus.n_docs, dtype=np.int64))
        result: Optional[RoaringBitmap] = None
        for conj in spec.split("&"):
            conj = conj.strip()
            acc: Optional[RoaringBitmap] = None
            for term in conj.split("|"):
                term = term.strip()
                neg = term.startswith("!")
                term = term.lstrip("!")
                if ">=" in term:
                    attr, v = term.split(">=")
                    bm = RoaringBitmap()
                    for val, rb in self.index[attr.strip()].items():
                        if val >= int(v):
                            bm = bm | rb
                elif "=" in term:
                    attr, v = term.split("=")
                    bm = self.bitmap(attr.strip(), int(v))
                else:
                    bm = self.bitmap(term, 1)
                if neg:
                    bm = universe.andnot(bm)
                acc = bm if acc is None else (acc | bm)
            result = acc if result is None else (result & acc)
        return result if result is not None else universe


# =============================================================================
# deterministic sharded loader
# =============================================================================

@dataclasses.dataclass
class PipelineState:
    query: str
    epoch: int = 0
    cursor: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(**d)


class DataPipeline:
    """Packs selected documents into fixed [batch, seq] token blocks.

    ``next_batch`` is deterministic in (state, shard_id): every data-parallel
    shard draws disjoint document slices of the epoch permutation, and the
    post-restart stream equals the uninterrupted one.
    """

    def __init__(self, index: BitmapIndex, state: PipelineState,
                 batch: int, seq_len: int, n_shards: int = 1,
                 shard_id: int = 0):
        self.index = index
        self.state = state
        self.batch = batch
        self.seq_len = seq_len
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.selection = index.query(state.query).to_array()
        if self.selection.size == 0:
            raise ValueError(f"empty selection: {state.query}")

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.state.seed + epoch * 1000003)
        return rng.permutation(self.selection)

    def doc_start_bitmap(self, tokens_meta: List[int]) -> RoaringBitmap:
        """Document-start token offsets as a roaring bitmap (feeds the
        doc-boundary attention mask)."""
        return RoaringBitmap.from_array(tokens_meta)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray, RoaringBitmap]:
        """Returns (tokens [B, S+1], loss_mask [B, S+1], doc_starts bitmap)."""
        B, S = self.batch, self.seq_len + 1
        out = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        doc_starts: List[int] = []
        perm = self._perm(self.state.epoch)
        cursor = self.state.cursor + self.shard_id
        for b in range(B):
            fill = 0
            while fill < S:
                if cursor >= perm.size:
                    self.state.epoch += 1
                    perm = self._perm(self.state.epoch)
                    cursor = self.shard_id
                doc = int(perm[cursor])
                cursor += self.n_shards
                toks = self.index.corpus.tokens(doc, S - fill)
                doc_starts.append(b * S + fill)
                out[b, fill: fill + toks.size] = toks
                mask[b, fill: fill + toks.size] = 1.0
                fill += toks.size + 1          # EOS gap
        self.state.cursor = cursor - self.shard_id
        return out, mask, RoaringBitmap.from_array(doc_starts)
