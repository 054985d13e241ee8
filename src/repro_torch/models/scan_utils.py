"""Chunked sequence scan with per-chunk recomputation.

A scan's backward keeps the carried state of every step: for a selective
SSM layer at 4k tokens that is seq_len x [B, d_inner, d_state] floats.
Splitting the scan into checkpointed chunks keeps one carry per *chunk*
and recomputes the inner steps in the backward pass: memory drops by the
chunk factor for ~2x scan work (the standard recurrent-training trade).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _scan(f, carry, xs):
    """``lax.scan`` over the leading axis of every tensor of the tuple
    ``xs``: ``f(carry, x_t) -> (carry, y_t)``; returns ``(carry, ys)`` with
    the ``y_t`` stacked along a new leading axis."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = f(carry, tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(f, init, xs, chunk_size: int = 256):
    """The reference's ``chunked_scan`` over the leading time axis of the
    tuple of tensors ``xs``: a plain loop when the sequence is at most one
    chunk or not a multiple of it, else checkpointed chunks of
    ``chunk_size`` steps (only each chunk's carry is kept for the
    backward)."""
    T = xs[0].shape[0]
    if T <= chunk_size or T % chunk_size != 0:
        return _scan(f, init, xs)
    carry, ys = init, []
    for c0 in range(0, T, chunk_size):
        xc = tuple(a[c0:c0 + chunk_size] for a in xs)
        carry, yc = checkpoint(_scan, f, carry, xc, use_reentrant=False)
        ys.append(yc)
    return carry, torch.cat(ys)
