#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--terms N] [--seed S]

Builds the hand-written CUDA kernels from ``src/repro_torch`` and holds
each against its plain-torch version on the card. Then it drives the
paths of the port end to end:

* the search service at full size — an index shaped like the MS MARCO
  passage-ranking corpus (8,841,823 documents, C = 135 chunk rows per term)
  over a 2,048-term Zipf vocabulary — in modes count / docs / topk, fused
  and per-op, checking sampled answers against an independent numpy
  oracle;
* the bitmap-index store over the Star Schema Benchmark's LINEORDER at SF
  10 (60,000,000 rows generated from the spec's column domains; equality
  and bit-sliced columns, 916 chunks), answering the Q1 flight fused and
  per-op against a numpy row filter, with a save / load round trip; then
  the word-op and packed-array kernels through their entry points at the
  store's own rows;
* LM serving on the Roaring-paged KV cache at gemma2-2b's full width and
  depth (random weights from a seeded generator): 8 short requests and one
  whose prompt runs past the 4,096-token sliding window, each checked
  against greedy decoding over the port's own teacher-forced ``forward``;
* gemma2-2b training at full width and depth with Roaring block-sparse
  attention on its 13 global layers: AdamW steps at train_4k's sequence of
  4,096 tokens (batch cut to 1) from the bitmap-indexed data pipeline, with
  step 0 checked against the same step through the kernel's plain version
  and the loss falling; then the training launcher at the reduced config
  under ``ResilientTrainer`` with a simulated failure, ending on the
  parameters of an uninterrupted run;
* the paper's comparison (Chambi et al., 2014): the search terms at Zipf
  ranks 1, 2, 4, ..., 2,048 and the store's ``lo_year = 1993`` /
  ``lo_discount = 1`` pair in four formats — Roaring's serialized bytes
  against WAH's, Concise's and BitSet's, and AND / OR with Roaring on the
  card and on the host against WAH and Concise on the host, every result
  equal;
* sharded search: ``PostingIndex.shard`` over a one-rank NCCL
  ``DeviceMesh``, the 96 top-k queries identical to the local index's;
* the rest of the model registry: dbrx-132b at full width (8 of its 40
  layers, bf16, 16 experts top-4) behind ``ServeEngine`` on the paged
  cache, each engine step held to the dense-cache ``decode_step`` over the
  same batch (a MoE's output depends on the batch it is routed with, so
  teacher-forced ``forward`` is no oracle there); rwkv6-1.6b and
  whisper-base (``encode`` over 256 stub frames) at full width and depth,
  streamed through ``decode_step`` and held to teacher-forced ``forward``;
  the reduced jamba, qwen2-vl, llama4, starcoder2 and stablelm-3b configs
  on the card against the CPU; and the paged decode kernel at dbrx's and
  starcoder2's head shapes;
* gemma2-2b training with the Roaring top-k cross-pod gradient mean
  (``grad_compression``, ratio 0.01) under a one-rank ``("pod",)`` mesh,
  every leaf of step 0 checked against the top-k definition and the
  embedding leaf's support overlaps against ``np.intersect1d``; then the
  analytic FLOP rates (``models/flops.py``) of the training and serving
  runs;
* training the rest of the registry: qwen2-vl-72b at full width (4 of its
  80 layers, bf16 as published) on 64 stub patches and 1,984 tokens, every
  layer through the block-sparse kernel (D = 128, G = 8), with
  ``pick_optimizer``'s Adafactor: step 0 held to the plain version, the
  loss falling, the Adafactor state's shapes held to the reference's
  rule, then one step under remat "dots" held to "full"; and every
  reduced config trained two steps on the card against the CPU
  (``pick_optimizer``'s optimizer, 8-bit AdamW and remat "dots" on one
  config each, qwen2-vl's patches, whisper with and without memory);
* the dry run (``launch/dryrun.py``) of every architecture x shape x
  production mesh on ``meta`` tensors, then ``launch.specs.build_cell``'s
  gemma2-2b long_500k decode cell realized on the card at full width and
  depth (batch 1, a dense KV cache of 524,288 positions): every leaf
  realized with the built shape and dtype; its first 8 positions are held
  to a 64-position cache; 8 steps at the last positions of a cache seeded
  below them are timed; and the last global layer's dense attention is
  held to the paged decode kernel over the same 524,288 rows seen as pages
  12 GiB and more into a pool of the whole stacked cache, first as the
  step left them, then with a few rows planted to carry the softmax.

It then times each kernel on the inputs its path gave it (device time
alone: a spin on the card ahead of each start event outlasts the host's
enqueue, checked by a self-test first), and profiles warm windows to show
where the time goes (host spans, device busy share, top
device work). The line before the last is one JSON object describing every
kernel; the last line is the device contract.

Exits non-zero, printing no result, when no CUDA card is present or any
phase fails. Imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

N_DOCS = 8_841_823            # MS MARCO passage-ranking corpus size
N_TERMS = 2048
ZIPF_S = 1.1
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
# integer / bit work runs on the CUDA cores; the card's published
# non-tensor peak (67 TFLOP/s fp32, H100 SXM) bounds it
SCALAR_OPS_PER_S = 67e12
# bf16 dense tensor-core peak (H100 SXM): the least time for bf16 inputs
BF16_OPS_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20

# the serving phase: gemma2-2b at full width and depth
SERVE_ARCH = "gemma2-2b"
SERVE_ENGINE = dict(max_batch=4, n_pages=1024, page_size=16,
                    max_pages_per_seq=320)
SERVE_NEW = 16
# one prompt past the 4,096-token window, so local layers decode with
# starts > 0; its teacher-forced length 4,201 + 15 = 4,216 is off the
# multiples of 512 where forward would take the unported blocked branch
LONG_PROMPT = 4201
# greedy check: where the top-2 logit gap of the teacher-forced forward is
# at least GAP_TOL the engine's token is forward's argmax; below it (a
# near-tie) the engine may take the runner-up, within tolerance. Both paths
# compute in bf16 but round at other places (the decode path's paged cache
# and kernel against forward's attention), so the engine's logits are held
# to forward's within what one bf16 ulp in each element of forward's final
# hidden state x can move a logit: tol(v) = LOGIT_ULP * sum_d |x_d| |W_vd|
# (bf16 has 8 significant bits, so an ulp is at most 2^-7 of the value; the
# logit softcap, 30 tanh(z / 30), moves a logit no more than z). At every
# step the engine's top logit is within tol(token) of forward's logit for
# the engine's token; at a near-tie, forward's logit for that token is
# within tol(top) + tol(token) of forward's top logit. forward is fed the
# engine's own tokens, so the steps after a near-tie stay comparable
GAP_TOL = 1e-2
LOGIT_ULP = 2.0 ** -7
# paged decode against its plain version: bf16 outputs, one rounding apart
# (one ulp is 2**-7 below magnitude 2) on the check grid's short rows; the
# long-split case, decode_32k and the serving launches hold each bf16
# output vector (a sequence's query head) within LONG_PAGED_ULPS ulps of
# its own largest element instead (``paged_error``)
BF16_ATOL = 1e-2
F32_ATOL = 1e-5
# paged decode timings start after this many untimed calls: the first
# timed calls on a freshly made decode_32k input have read slow (qwen2-vl's
# heads, made after stablelm-3b's input), the same calls later not
WARM_CALLS = 20

# the dry run (launch/dryrun.py: 10 architectures x 4 shapes x 2 meshes) and
# build_cell's long_500k decode cell realized on the card at full width and
# depth: gemma2-2b, batch 1, a dense cache of 524,288 positions, on a
# one-rank mesh. Its first LONG_STEPS positions are held to the same steps
# through a LONG_SHORT_CACHE-position cache. Masked columns add nothing,
# so only the order of sums differs: in f32 compute (one super-block, the
# cell's widths) the logits agree within LONG_F32_RTOL of the largest; in
# the cell's bf16 compute such differences round to other bf16 values, so
# every logit is held to the serving rule (LOGIT_ULP: one bf16 ulp in each
# element of the final hidden state). Then the cache below the last
# LONG_STEPS positions is filled from the seed, LONG_STEPS steps there are
# timed, and the last one's global-layer dense attention is held to
# paged_decode over the same rows seen as pages of LONG_PAGE. The pool is
# the whole stacked cache of that layer kind, so the last super-block's
# pages lie 12 GiB and more into it. Both outputs are bf16, so the
# tolerance scales with the output: LONG_PAGED_ULPS bf16 ulps of its
# largest element (a softmax over 524,288 random rows gives outputs near
# 1e-3, where a flat 1e-2 would pass a kernel that returned zeros). Then
# LONG_PLANTED rows (position, query head of the group, score before the
# softcap) are planted in that layer's pages for a seeded query of unit
# variance, so the planted rows carry all but ~1e-6 of the softmax and a
# page read from the wrong place moves the output by O(1)
DRY_ARCHS = ("gemma2-2b", "qwen2-vl-72b", "dbrx-132b")
DRY_CELLS = 80
LONG_ARCH = "gemma2-2b"
LONG_SHAPE = "long_500k"
LONG_MESH = {"data": 1, "model": 1}
LONG_STEPS = 8
LONG_SHORT_CACHE = 64
LONG_F32_RTOL = 1e-4
LONG_PAGE = 16
LONG_PAGED_ULPS = 2
LONG_PLANTED = ((-1, 0, 30.0), (1 << 18 | 7, 0, 29.5),
                (-LONG_PAGE - 3, 1, 30.0), (12_345, 1, 29.5))

# the registry's other architectures. dbrx-132b at full width behind the
# paged engine, cut to 8 of its 40 layers (bf16 weights, 6.52 GB a layer:
# 40 would not fit the card's 80 GB), the gemma2 phase's traffic. Every
# step's dense-cache replay routes as the engine step did, so its logits
# are always compared. The paged kernel and the dense path round attention
# at other places, and over 8 bf16 layers the router probabilities drift
# apart: by up to 0.0103 over every row and layer with the default seed on
# an H100, so they must agree within ROUTER_DRIFT, about twice that. Where
# the replay would have chosen other experts for a row by itself, that
# row's k-th and (k+1)-th router probabilities must lie within ROUTER_TIE
# (a router near-tie; such gaps measured up to 1.73e-3 on an H100)
DBRX_ARCH = "dbrx-132b"
DBRX_LAYERS = 8
DBRX_ENGINE = dict(max_batch=4, n_pages=64, page_size=16,
                   max_pages_per_seq=4)
DBRX_REQUESTS = 8
ROUTER_DRIFT = 2e-2
ROUTER_TIE = 5e-3
# rwkv6-1.6b and whisper-base at full width and depth: 4 prompts streamed
# through decode_step, STREAM_NEW greedy tokens each; whisper's encoder over
# launch/specs.py's ENC_FRAMES (256) stub frames
STREAM_NEW = 16
# the other reduced configs on the card against the CPU, f32 compute: sums
# in another order on another device, through at most 8 layers
REGISTRY_ARCHS = ("jamba-1.5-large-398b", "qwen2-vl-72b",
                  "llama4-maverick-400b-a17b", "starcoder2-15b",
                  "stablelm-3b")
REG_ATOL, REG_RTOL = 1e-4, 1e-3

# the training phase: gemma2-2b at full width and depth, Roaring block-sparse
# attention on the global layers; train_4k's sequence, batch cut 256 -> 1
TRAIN_ARCH = "gemma2-2b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 1
TRAIN_STEPS = 8
TRAIN_QUERY = "quality>=1&!dedup_dup"
TRAIN_MASK = dict(pattern="local_global", window_blocks=8, n_global=4)
TRAIN_LIVE_BLOCKS = 318
# step 0 through the kernel against step 0 through its plain version, bf16
# compute: the two round the global layers' outputs to bf16 from f32 sums
# taken in another order (one ulp is 2**-8 relative), at different places
# in 13 layers; the loss, a mean over 4,096 positions, moves far less than
# LOSS_RTOL, and the grad norm, a root of a sum over 2.6 B squares, less
# than GNORM_RTOL
LOSS_RTOL = 2e-3
GNORM_RTOL = 2e-2
# the compressed training phase: the Roaring top-k cross-pod gradient mean
# at the reference's default ratio, on the same model, batch and block lists
COMP_RATIO = 0.01
COMP_STEPS = 3
BF16_TFLOPS = 989.0           # H100 SXM dense bf16 peak (NVIDIA data sheet)
# training the rest of the registry: qwen2-vl-72b (configs/qwen2_vl_72b.py,
# arXiv:2409.12191) at full width and bf16 as published, CUT to 4 of its 80
# layers, every layer through the block-sparse kernel (D = 128, G = 8);
# batch 1 x 2,048 positions (launch/specs.py's 64 stub patches, then 1,984
# tokens); 81 of 256 blocks live. pick_optimizer's Adafactor at a constant
# learning rate: its own schedule warms up over 2,000 steps, which leaves
# bf16 parameters unchanged over a few steps
QWEN_ARCH = "qwen2-vl-72b"
QWEN_LAYERS = 6
QWEN_SEQ = 2048
QWEN_STEPS = 4
QWEN_MASK = dict(pattern="local_global", window_blocks=4, n_global=2)
QWEN_LIVE_BLOCKS = 81
QWEN_LR = 1e-4
QWEN_AB = 3                 # warmed steps of remat "full" and "dots" in turn
# then every reduced config trains on the card against the CPU (f32), with
# pick_optimizer's optimizer at a constant rate; 8-bit AdamW on one config,
# remat "dots" on another
REG_TRAIN_STEPS = 2
REG_SEQ = 256
REG_LR = 1e-3
REG_ADAMW8BIT = "stablelm-1.6b"
REG_DOTS = "dbrx-132b"
# the launcher phase: reduced gemma2-2b, one simulated failure
LAUNCH_ARGS = ["--arch", "gemma2-2b", "--reduced", "--steps", "6",
               "--batch", "2", "--seq", "256", "--ckpt-every", "2",
               "--log-every", "100"]
LAUNCH_FAIL_AT = {3}

# the store phase: SSB LINEORDER (O'Neil, O'Neil, Chen, Revilak, Star
# Schema Benchmark rev. 3, 2009) as a bitmap index, queried by the Q1 flight
SSB_SF = 10
SSB_ROWS_PER_SF = 6_000_000
SSB_FIRST_DAY = np.datetime64("1992-01-01")
SSB_DAYS = int((np.datetime64("1998-08-02") - SSB_FIRST_DAY).astype(
    np.int64)) + 1
SSB_BSI = ("lo_quantity", "lo_extendedprice")
SSB_RATE_S = 3.0              # closed-loop fused count, seconds per query
# the paper's rows: the search terms at Zipf ranks 1, 2, 4, ..., 2,048 (the
# density sweep of the paper's figures) and one pair of the store's columns
PAPER_RANKS = tuple(2 ** i for i in range(12))
PAPER_DB_PAIR = (("lo_year", 1993), ("lo_discount", 1))
PAPER_REPEATS = 5
CONTAINER_OPS = ("and", "or", "xor", "andnot")
# the kernels each path must launch
SEARCH_KERNELS = ("intersect_dispatch", "intersect_dispatch_stacked",
                  "fused_tree")

# where each ported kernel replaces a TPU kernel
KERNELS = {
    "intersect_dispatch": (
        "src/repro_torch/kernels/roaring/csrc/intersect_dispatch.cu",
        "src/repro/kernels/roaring/kernel.py:254"),
    "intersect_dispatch_stacked": (
        "src/repro_torch/kernels/roaring/csrc/intersect_dispatch.cu",
        "src/repro/kernels/roaring/kernel.py:289"),
    "fused_tree": (
        "src/repro_torch/kernels/roaring/csrc/fused_eval.cu",
        "src/repro/kernels/roaring/fused.py:232"),
    "paged_decode": (
        "src/repro_torch/kernels/sparse_attn/csrc/paged_decode.cu",
        "src/repro/kernels/sparse_attn/kernel.py:179"),
    "sparse_flash_attention": (
        "src/repro_torch/kernels/sparse_attn/csrc/sparse_flash.cu",
        "src/repro/kernels/sparse_attn/kernel.py:79"),
    "container_op": (
        "src/repro_torch/kernels/roaring/csrc/container_ops.cu",
        "src/repro/kernels/roaring/kernel.py:118"),
    "array_intersect": (
        "src/repro_torch/kernels/roaring/csrc/container_ops.cu",
        "src/repro/kernels/roaring/kernel.py:184"),
}


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# =============================================================================
# bounds: bytes each function must move, operations it must do
# =============================================================================

def _side_bytes(kind, card, nruns):
    return np.where(kind == 1, 2 * card, np.where(
        kind == 2, 8192, np.where(kind == 3, 4 * nruns, 0))).astype(np.int64)


def _log2(x):
    return np.ceil(np.log2(np.maximum(x, 1) + 1)).astype(np.int64)


def _probed_sectors(torch, rows, which, cards, chunk=8192):
    """bool[len(which), 256]: the 32-byte sectors of a bitmap row that the
    packed array ``rows[which]`` (its first ``cards`` slots) probes."""
    out = torch.zeros((which.numel(), 256), dtype=torch.bool,
                      device=rows.device)
    slot = torch.arange(rows.shape[1], device=rows.device)
    for s in range(0, which.numel(), chunk):
        v = (rows[which[s:s + chunk]].to(torch.int64) & 0xFFFF) >> 8
        v = torch.where(slot < cards[s:s + chunk, None], v, 256)
        hit = torch.zeros((v.shape[0], 257), dtype=torch.bool,
                          device=rows.device)
        out[s:s + chunk] = hit.scatter_(1, v, True)[:, :256]
    return out


def dispatch_bound(torch, a, b, meta, hits_written):
    """(bound_ms, bound_by) of one dispatch launch over pairs (a[r], b[r %
    len(b)]): every pair reads its 24-byte meta and writes its card (and
    its 8 kB hits row when written); a live pair reads its a row once and
    every b row is read once for all its pairs. An array or run side
    counts its packed values; a bitmap side counts 8 kB, or in a probe
    cell (array x bitmap) only the 32-byte sectors the array's values hit."""
    m = meta.view(-1, 6).to(torch.int64)
    ka, kb, ca, cb, ra, rb = m.unbind(1)
    R, Rb = a.shape[0], b.shape[0]
    brow = torch.arange(R, device=a.device) % Rb
    live = (ka > 0) & (kb > 0)
    nbytes = R * (24 + 4 + (8192 if hits_written else 0))
    # a side, per live pair
    packed = lambda k, c, n: torch.where(  # noqa: E731
        k == 1, 2 * c, torch.where(k == 3, 4 * n, 0))
    nbytes += int(packed(ka, ca, ra)[live].sum())
    nbytes += 8192 * int((live & (ka == 2) & (kb != 1)).sum())
    probe = torch.nonzero(live & (ka == 2) & (kb == 1)).flatten()
    nbytes += 32 * int(_probed_sectors(torch, b, brow[probe],
                                       cb[probe]).sum())
    # b side, per row, for the union of its live pairs
    used = torch.zeros(Rb, dtype=torch.int64, device=a.device)
    used.scatter_reduce_(0, brow[live], packed(kb, cb, rb)[live], "amax")
    nbytes += int(used.sum())
    full = torch.zeros(Rb, dtype=torch.bool, device=a.device)
    full[brow[live & (kb == 2) & (ka != 1)]] = True
    probe = torch.nonzero(live & (ka == 1) & (kb == 2)).flatten()
    need = torch.zeros((Rb, 256), dtype=torch.int32, device=a.device)
    need.index_add_(0, brow[probe], _probed_sectors(
        torch, a, probe, ca[probe]).to(torch.int32))
    nbytes += 32 * int(torch.where(full, 256, (need > 0).sum(1)).sum())
    # operations: gallop / probe / run search per array slot, word ops and
    # coverage searches per 32-bit word of the bits cells
    ka, kb, ca, cb, ra, rb, live = (x.cpu().numpy() for x in
                                    (ka, kb, ca, cb, ra, rb, live))
    arr_a, arr_b = ka == 1, kb == 1
    ops = np.where(arr_a & arr_b, ca * (4 * _log2(cb) + 4), 0)
    ops += np.where(arr_a & (kb == 2), ca * 6, 0)
    ops += np.where((ka == 2) & arr_b, cb * 6, 0)
    ops += np.where(arr_a & (kb == 3), ca * (4 * _log2(rb) + 6), 0)
    ops += np.where((ka == 3) & arr_b, cb * (4 * _log2(ra) + 6), 0)
    ops += np.where((ka == 2) & (kb == 2), 2048 * 3, 0)
    ops += np.where((ka == 3) & (kb == 2), 2048 * (4 * _log2(ra) + 10), 0)
    ops += np.where((ka == 2) & (kb == 3), 2048 * (4 * _log2(rb) + 10), 0)
    ops += np.where((ka == 3) & (kb == 3),
                    2048 * (4 * _log2(ra) + 4 * _log2(rb) + 12), 0)
    return _bound(nbytes, int(ops[live].sum()))


def fused_bound(meta, n_ops_per_col, N, C):
    """(bound_ms, bound_by) of one fused launch: every live column reads
    each operand row once; every column writes its root row and card."""
    f = meta[:3 * N * C].reshape(N, C, 3).astype(np.int64)
    live = meta[3 * N * C:] != 0
    kind, card, nruns = f[..., 0], f[..., 1], f[..., 2]
    nbytes = meta.size * 4 + C * (8192 + 4)
    nbytes += int((_side_bytes(kind, card, nruns) * live[None, :]).sum())
    lift = np.where(kind == 1, card, np.where(
        kind == 2, 2048, np.where(kind == 3, 2048 * (4 * _log2(nruns) + 10),
                                  0)))
    ops = (lift * live[None, :]).sum() + live.sum() * 2048 * (
        2 * n_ops_per_col + 3)
    return _bound(nbytes, int(ops))


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# timers: the card opens the interval, not the host
# =============================================================================

# SM clock cycles in one ms of ``torch.cuda._sleep``, set by timer_self_test
_CYCLES_PER_MS = None


def _host_ms(torch, fn, n):
    """Host ms to enqueue ``n`` calls of ``fn`` (the card may lag)."""
    t = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    return ms


def _card_opened_ms(torch, enqueue, host_ms):
    """``enqueue(start, end)`` behind a spin on the card that outlasts the
    host's ``host_ms`` of enqueueing, so the card reaches ``start`` only
    once the host has queued everything up to ``end``: the interval holds
    device work alone. Checked, not assumed: if ``start`` has passed by the
    time ``end`` is queued, the spin is doubled and the call repeated; a
    call that synchronises never passes and raises."""
    for attempt in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin_ms = (2 * host_ms + 0.2) * 2 ** attempt
        torch.cuda._sleep(max(1, int(spin_ms * _CYCLES_PER_MS)))
        enqueue(start, end)
        early = start.query()
        end.synchronize()
        if not early:
            return start.elapsed_time(end)
    raise AssertionError("timer: the card reached the start event before "
                         "the host had queued the call (does it "
                         "synchronise?)")


def time_ms(torch, fn, iters, warmup=1):
    """Mean device ms of ``iters`` back-to-back calls of ``fn`` (warm
    caches), the interval opened by the card (``_card_opened_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = _host_ms(torch, fn, iters)

    def enqueue(start, end):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    return _card_opened_ms(torch, enqueue, host) / iters


def time_cold_ms(torch, fn, iters, flush):
    """Mean device ms of ``fn`` alone, with the L2 cache overwritten before
    each call (the serving path reads each layer's KV after the other
    layers' weights have passed through it), the interval opened by the
    card (``_card_opened_ms``)."""
    fn()
    torch.cuda.synchronize()
    host = _host_ms(torch, lambda: (flush.zero_(), fn()), 3) / 3

    def enqueue(start, end):
        flush.zero_()
        start.record()
        fn()
        end.record()
    return sum(_card_opened_ms(torch, enqueue, host)
               for _ in range(iters)) / iters


def enqueue_time_ms(torch, fn, iters, warmup=1):
    """``time_ms`` without the spin: the host records the start event and
    then enqueues, so where the calls' host work outlasts the card's, the
    interval holds host time. Times the plain versions (which synchronise:
    their time is host and device together) and gives the host-opened
    reading logged beside each kernel's card-opened one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_time_cold_ms(torch, fn, iters, flush):
    """``time_cold_ms`` without the spin (see ``enqueue_time_ms``)."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def timer_self_test(torch):
    """Sets the spin's clock from a 2,000,000-cycle ``torch.cuda._sleep``,
    then checks the timers: an empty call must read ~0 ms warm and cold, a
    call of 0.5 ms host work and no device work too (the host-opened timer
    reads its host time), and a ``_sleep`` of known cycles its length at
    the SM clock ``nvidia-smi`` reports."""
    global _CYCLES_PER_MS
    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    _CYCLES_PER_MS = cycles / a.elapsed_time(b)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def host_only():
        t = time.perf_counter()
        while time.perf_counter() - t < 5e-4:
            pass
    known = 200_000
    got = {
        "empty warm": time_ms(torch, lambda: None, 20),
        "empty cold": time_cold_ms(torch, lambda: None, 20, flush),
        "host-only warm": time_ms(torch, host_only, 20),
        "host-only cold": time_cold_ms(torch, host_only, 20, flush),
        "host-only, host-opened timer": enqueue_time_ms(torch, host_only, 20),
        f"{known}-cycle sleep": time_ms(
            torch, lambda: torch.cuda._sleep(known), 10),
    }
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("timer self-test (ms): " + ", ".join(
        f"{k} {v:.5f}" for k, v in got.items())
        + f"; the sleep reads {known / got[f'{known}-cycle sleep'] / 1e3:.0f}"
        f" MHz (nvidia-smi clocks.sm, clocks.max.sm: {clocks}); spin clock "
        f"{_CYCLES_PER_MS / 1e3:.0f} MHz ({card_line()})")
    if max(got["empty warm"], got["host-only warm"]) > 0.005 or max(
            got["empty cold"], got["host-only cold"]) > 0.01:
        raise AssertionError("timer self-test: a call without device work "
                             "does not read ~0 ms")


# =============================================================================
# phases
# =============================================================================

def check_kernels(torch, cases, K, ops, ref, F, seed):
    """Every kernel against its plain version on seeded rows covering all
    nine pair classes, dead pairs, the 4095/4096/4097 boundaries, runs
    ending at 65535, a run covering the chunk, stacked N*C grids, fused
    trees of depth 1-5 and a 31-slot plan at every launch shape, and a
    61-slot and a 64-operand plan too large for shared memory."""
    rng = np.random.default_rng(seed)
    rows = cases.case_rows(rng)
    names = list(rows)
    A, B, meta = cases.pair_grid(rows, names, names)
    A = torch.from_numpy(A.view(np.int16)).cuda()
    B = torch.from_numpy(B.view(np.int16)).cuda()
    meta = torch.from_numpy(meta).cuda()
    classes = {(rows[a][0], rows[b][0]) for a in names for b in names
               if rows[a][0] and rows[b][0]}
    if len(classes) != 9:
        raise AssertionError(f"expected 9 pair classes, got {len(classes)}")

    hk, ck = K.intersect_dispatch_cuda(A, B, meta)
    hp, cp = ref.intersect_dispatch_ref(A, B, meta)
    _same("intersect_dispatch", (hk, ck), (hp, cp))
    log(f"check intersect_dispatch: {A.shape[0]} pairs (9 classes + dead) "
        "bit-identical")

    C = len(names)
    N = A.shape[0] // C
    A3, B3 = A.reshape(N, C, -1), B.reshape(N, C, -1)
    m2 = meta.reshape(N, 6 * C)
    hk, ck = ops.intersect_dispatch_stacked(A3, B3, m2)
    hp, cp = ref.intersect_dispatch_ref(A, B, meta)
    _same("intersect_dispatch_stacked", (hk.reshape(-1, 4096),
                                         ck.reshape(-1)), (hp, cp))
    q = B3[0].contiguous()                     # B row r is partner r % C
    card_only = ops.stacked_and_card(A3, q, m2)
    _same("intersect_dispatch_stacked card-only", (card_only.reshape(-1),),
          (cp,))
    log(f"check intersect_dispatch_stacked: {N}x{C} grid, hits+card and "
        "card-only with a shared query, bit-identical")

    Nf, Cf = 4, 48
    pick = rng.integers(0, 2 * A.shape[0], size=(Nf, Cf))
    from_b = torch.from_numpy(pick >= A.shape[0]).cuda()
    rowsel = torch.from_numpy(pick % A.shape[0]).cuda()
    fops = torch.where(from_b[..., None], B[rowsel], A[rowsel])
    fm = meta.reshape(-1, 6)
    kind = torch.where(from_b, fm[rowsel, 1], fm[rowsel, 0])
    card = torch.where(from_b, fm[rowsel, 3], fm[rowsel, 2])
    nr = torch.where(from_b, fm[rowsel, 5], fm[rowsel, 4])
    kind[:, -1] = 0                                      # a dead column
    lm = F.pack_lift_meta(kind, card, nr)
    trees = [0, ("and", 0, 1), ("or", 0, 1, 2), ("andnot", 0, 1),
             ("andnot", ("or", 0, 1, 2), ("and", 3, 1)),
             ("or", ("and", 0, ("andnot", 1, 2)), ("andnot", 3, ("or", 0, 2))),
             ("and", ("or", ("andnot", ("and", 0, 1), 2), 3),
              ("or", 1, ("andnot", 3, ("and", 0, 2))))]
    trees += [_deep_tree(30), _deep_tree(60)]
    smem = K.fused_smem(fops.device)
    shapes = {}
    for tree in trees:
        plan = F.plan_tape(tree)
        want = F.fused_eval_ref(fops.contiguous(), lm, plan=plan)
        for shape in K.fused_shapes(len(F.kernel_program(plan)[0]),
                                    plan.n_slots, smem[0]):
            got = K.fused_eval_cuda(fops.contiguous(), lm, plan, shape=shape)
            _same(f"fused_tree {plan.n_slots} slots at {shape}", got, want)
        shapes[plan.n_slots] = K.fused_launch_shape(
            len(F.kernel_program(plan)[0]), plan.n_slots, *smem)
    # more distinct operands than one block's shared memory holds
    Nw = 64
    pick = rng.integers(0, A.shape[0], size=(Nw, Cf))
    rowsel = torch.from_numpy(pick).cuda()
    wops = A[rowsel].contiguous()
    wkind = fm[rowsel, 0].clone()
    wkind[:, -1] = 0                                     # a dead column
    wm = F.pack_lift_meta(wkind, fm[rowsel, 2], fm[rowsel, 4])
    wide = F.plan_tape(("or", ("and", 0, 1),
                        *[(("and", "andnot")[i % 2], i, i + 1)
                          for i in range(2, Nw - 1)]))
    wshape = K.fused_launch_shape(Nw, wide.n_slots, *smem)
    _same("fused_tree, 64 operands", K.fused_eval_cuda(wops, wm, wide),
          F.fused_eval_ref(wops, wm, plan=wide))
    if not shapes[31][2] or shapes[61][2] or wshape[2]:
        raise AssertionError(f"fused launch shapes {shapes}, {wshape}: the "
                             "31-slot plan should run in shared memory, "
                             "the 61-slot and 64-operand plans in global "
                             "scratch")
    log(f"check fused_tree: {len(trees)} trees (depth 1-5, and/or/andnot) "
        "at every launch shape the kernel is built for, and a 64-operand "
        "plan, bit-identical; (split, stack rows, in shared memory): "
        f"{shapes} by slots, {wshape} for 64 operands "
        f"({smem[0]} B of shared memory a block, {smem[1]} an SM)")


def _deep_tree(depth):
    """A right-nested tree of ``depth`` ops over operands 0-3: ``depth +
    1`` slots."""
    tree = 3
    for i in range(depth):
        tree = (("and", "or", "andnot")[i % 3], i % 4, tree)
    return tree


def _same(what, got, want):
    for g, w in zip(got, want):
        if not (g.dtype == w.dtype and g.shape == w.shape
                and bool((g == w).all())):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 "version")


def make_queries(S, terms, n, seed):
    """A Zipf stream of 2-4-term And/Or/AndNot trees (five shapes, mixed)."""
    rng = np.random.default_rng(seed)
    shapes = []
    for i, (k, op) in enumerate([(2, "and"), (3, "or"), (4, "and"),
                                 (3, "and"), (3, "or")]):
        shapes.append(S.zipf_queries(terms, n, ZIPF_S, seed + i,
                                     terms_per_query=k, op=op))
    out = []
    for j, which in enumerate(rng.integers(0, 5, size=n)):
        q = shapes[which][j]
        if which == 3:                 # (a AND b) ANDNOT c
            a, b, c = q.children
            q = S.andnot(S.and_(a, b), c)
        elif which == 4:               # a ANDNOT (b OR c)
            a, b, c = q.children
            q = S.andnot(a, S.or_(b, c))
        out.append(q)
    return out


class Oracle:
    """Independent host answers from the raw posting arrays."""

    def __init__(self, S, postings, terms):
        self.S, self.postings, self.terms = S, postings, terms

    def docs(self, q):
        S = self.S
        if isinstance(q, S.Term):
            return self.postings[q.term]
        if isinstance(q, S.AndNot):
            return np.setdiff1d(self.docs(q.a), self.docs(q.b),
                                assume_unique=True)
        vals = [self.docs(c) for c in q.children]
        out = vals[0]
        for v in vals[1:]:
            out = (np.intersect1d(out, v, assume_unique=True)
                   if isinstance(q, S.And) else np.union1d(out, v))
        return out

    def topk(self, q, k):
        """Brute-force scores over every index row (row 0 is the reserved
        empty posting, term None); ties keep the lower row first."""
        mask = np.zeros(N_DOCS, bool)
        mask[self.docs(q)] = True
        rows = [None] + list(self.terms)
        scores = np.array([0] + [int(mask[self.postings[t]].sum())
                                 for t in self.terms])
        top = np.argsort(-scores, kind="stable")[:k]
        return [(rows[r], int(scores[r])) for r in top]


def main_path(torch, S, K, obs, n_terms, seed, device="cuda"):
    """The search service end to end at full size; returns what the JSON
    line needs: launch counts and the inputs each kernel was given."""
    t0 = time.perf_counter()
    terms = [f"t{r:04d}" for r in range(n_terms)]     # name order = rank
    postings = dict(zip(terms, S.gen_zipf_postings(n_terms, N_DOCS, ZIPF_S,
                                                   seed)))
    t1 = time.perf_counter()
    index = S.PostingIndex.from_postings(postings, N_DOCS, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t2 = time.perf_counter()
    st = index.stack
    kinds = np.bincount(st.kinds.cpu().numpy().ravel(), minlength=4)
    log(f"index: {n_terms} terms over {N_DOCS} docs, C = {index.C}, stack "
        f"{tuple(st.payload.shape)} = {st.payload.numel() * 2 / 1e9:.3f} GB "
        f"on the card; containers empty/array/bitmap/run = "
        f"{kinds.tolist()}; corpus {t1 - t0:.1f} s, build {t2 - t1:.1f} s")
    if index.C != -(-N_DOCS // 65536):
        raise AssertionError(f"C = {index.C} does not cover {N_DOCS} docs")

    oracle = Oracle(S, postings, terms)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    obs.reset_metrics()
    svc = S.SearchService(index, max_batch=16, cache_slots=256, fused=True)
    stats = {}
    for mode, n in (("count", 1024), ("docs", 96), ("topk", 96)):
        qs = make_queries(S, terms, n, seed + len(stats))
        t = time.perf_counter()
        stats[mode] = S.run_closed_loop(svc, qs, concurrency=64, mode=mode,
                                        k=10)
        sync()
        log(f"fused {mode}: {n} requests in {time.perf_counter() - t:.2f} s")
    sample = make_queries(S, terms, 12, seed + 99)
    got_count = svc.search_many(sample, "count")
    got_docs = svc.search_many(sample, "docs")
    got_topk = svc.search_many(sample[:6], "topk", k=10)
    fused_batches = svc.steps_run
    per_op = S.SearchService(index, max_batch=16, cache_slots=256,
                             fused=False)
    per_op_qs = make_queries(S, terms, 128, seed + 7)
    t = time.perf_counter()
    stats["per_op count"] = S.run_closed_loop(per_op, per_op_qs,
                                              concurrency=64, mode="count")
    sync()
    log(f"per-op count: 128 requests in {time.perf_counter() - t:.2f} s")
    per_op_docs = per_op.search_many(sample, "docs")
    sync()
    launches = dict(K.launch_counts)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else float("nan"))

    for q, c, d, p in zip(sample, got_count, got_docs, per_op_docs):
        want = oracle.docs(q)
        if c != want.size or not np.array_equal(d, want):
            raise AssertionError(f"wrong answer for {q}")
        if not np.array_equal(p, d):
            raise AssertionError(f"fused and per-op disagree on {q}")
    for q, got in zip(sample[:6], got_topk):
        if got != oracle.topk(q, 10):
            raise AssertionError(f"wrong top-k for {q}")
    log(f"oracle: {len(sample)} count + docs answers, {len(got_topk)} top-k "
        "lists match the host numpy oracle; fused == per-op docs")

    reg = obs.registry()
    fallbacks = int(reg.total("index.fallbacks"))
    rung = int(reg.total("index.rung_taken", kind="fused", backend="cuda"))
    log(f"launches on the main path: {launches}; index.fallbacks = "
        f"{fallbacks}; index.rung_taken{{kind=fused,backend=cuda}} = {rung} "
        f"for {fused_batches} fused batches")
    if fallbacks != 0:
        raise AssertionError("the ladder dropped a rung on the card")
    if rung != fused_batches:
        raise AssertionError("not every fused batch ran the fused cuda rung")
    for name in SEARCH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")

    card = card_line() if device == "cuda" else device
    for mode, st in stats.items():
        log(f"{mode}: {st.qps:.1f} QPS, p50 {st.p50_us:.0f} us, p99 "
            f"{st.p99_us:.0f} us (closed loop, 64 in flight; {card})")
    hist = reg.histogram("search.latency_us")
    log(f"search.latency_us: n={hist.count} p50 "
        f"{S.percentile(hist, 50):.0f} us p99 {S.percentile(hist, 99):.0f} "
        f"us; max_memory_allocated {peak:.3f} GB ({card})")
    return launches, index, terms, postings


def capture_inputs(torch, S, K, index, terms, seed):
    """Per kernel entry, the launch with the most live work on the main
    path: the fused count and topk streams and the per-op count stream of
    ``main_path`` replayed on fresh services, after the timed windows, so
    that the capture's host reads never reach their numbers."""
    captured = {}

    def capture(name, fn, size):
        def wrapped(*args, **kw):
            entry = kw.get("entry", name)
            n = size(*args)
            if entry not in captured or n > captured[entry][0]:
                captured[entry] = (n, args, dict(kw))
            return fn(*args, **kw)
        return wrapped

    def live_pairs(a, b, meta, *rest):
        m = meta.view(-1, 6)
        return int(((m[:, 0] > 0) & (m[:, 1] > 0)).sum())

    def live_cells(ops, meta, *rest):      # live (operand, column) rows
        N, C = ops.shape[0], ops.shape[1]
        return int((meta[:3 * N * C:3] > 0).sum())

    orig = (K.intersect_dispatch_cuda, K.fused_eval_cuda)
    K.intersect_dispatch_cuda = capture("intersect_dispatch", orig[0],
                                        live_pairs)
    K.fused_eval_cuda = capture("fused_tree", orig[1], live_cells)
    try:
        for fused, mode, n, qseed in ((True, "count", 1024, seed),
                                      (True, "topk", 96, seed + 2),
                                      (False, "count", 128, seed + 7)):
            svc = S.SearchService(index, max_batch=16, cache_slots=256,
                                  fused=fused)
            S.run_closed_loop(svc, make_queries(S, terms, n, qseed),
                              concurrency=64, mode=mode, k=10)
        torch.cuda.synchronize()
    finally:
        K.intersect_dispatch_cuda, K.fused_eval_cuda = orig
    return captured


def where_time_goes(torch, S, obs, index, terms, seed):
    """Per mode, one warm closed-loop window under ``torch.profiler`` with
    the service's spans on: host time per span, device busy time (the sum
    of kernel and copy times; one stream, so they do not overlap) against
    the window's wall time, and the kernels that take the device time.
    The profiler and the spans add host time, so the idle share is an
    upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    card = card_line()
    svc = S.SearchService(index, max_batch=16, cache_slots=256, fused=True)
    for mode, n in (("count", 256), ("docs", 32), ("topk", 32)):
        qs = make_queries(S, terms, n, seed + 50)
        S.run_closed_loop(svc, qs, concurrency=64, mode=mode, k=10)
        torch.cuda.synchronize()
        obs.reset_traces()
        steps = svc.steps_run
        with obs.telemetry_scope(True), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            S.run_closed_loop(svc, qs, concurrency=64, mode=mode, k=10)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        spans, todo = {}, obs.span_trees()
        while todo:
            sp = todo.pop()
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration_s * 1e3
            todo.extend(sp.children)
        dev = {}
        for e in p.key_averages():      # kernels and copies, not host ops
            if e.device_type == DeviceType.CUDA:
                dev[e.key] = dev.get(e.key, 0.0) + (
                    e.self_device_time_total / 1e3)
        busy = sum(dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
        device = (f"device busy {busy:.2f} ms = {100 * busy / wall_ms:.1f} % "
                  f"of wall (idle {100 - 100 * busy / wall_ms:.1f} %); top "
                  "device work: " + "; ".join(f"{k[:60]} {v:.2f} ms"
                                              for k, v in top)
                  if busy > 0 else "device time not measured (the profiler "
                  "saw no device activity)")
        log(f"profile {mode}: {n} requests in {svc.steps_run - steps} "
            f"batches, wall {wall_ms:.1f} ms; host spans "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(spans.items()))
            + f"; {device} ({card})")


def kernel_rows(torch, K, ref, F, launches, captured, regs):
    """Time each kernel on the launch of the main path with the most live
    work, beside its plain version on the same input, and its bound; with
    the host-opened reading beside each card-opened one and the dispatch
    kernels' registers (``regs``, from ``build.ptxas_report``)."""
    out = []
    log("dispatch kernels: intersect_dispatch_kernel (hits, a block a "
        f"pair): {kernel_regs(regs, 'intersect_dispatch_kernel')}; "
        "stacked_card_kernel (card only) at 8 / 32 lanes a pair: "
        + "; ".join(kernel_regs(regs, f"stacked_card_kernelILi{g}E")
                    for g in (8, 32)))
    log("fused_eval_kernel at split 1 / split 2 / global scratch: "
        + "; ".join(kernel_regs(regs, f"fused_eval_kernelILi256ELi{v}ELb{b}")
                    for v, b in ((2, 1), (1, 1), (2, 0)))
        + "; array_intersect_kernel: "
        + kernel_regs(regs, "array_intersect_kernel"))
    # per-op AND combine: hits + card
    live, (a, b, meta), kw = captured["intersect_dispatch"]
    hk, ck = K.intersect_dispatch_cuda(a, b, meta)
    hp, cp = ref.intersect_dispatch_ref(a, b, meta)
    err = _max_err(torch, (hk, ck), (hp, cp))
    call = lambda: K.intersect_dispatch_cuda(a, b, meta)  # noqa: E731
    ms, old = time_ms(torch, call, 20), enqueue_time_ms(torch, call, 20)
    pms = enqueue_time_ms(torch, lambda: ref.intersect_dispatch_ref(
        a, b, meta), 3)
    bound = dispatch_bound(torch, a, b, meta, True)
    out.append(_row("intersect_dispatch", launches, err, ms, pms, bound,
                    f"{a.shape[0]} pairs ({live} live)", old_ms=old))

    # stacked top-k scoring: card only, the query's C rows read once
    live, (a, q, meta), kw = captured["intersect_dispatch_stacked"]
    _, ck = K.intersect_dispatch_cuda(a, q, meta, **kw)
    cp = _plain_card_only(torch, ref, a, q, meta)
    err = _max_err(torch, (ck,), (cp,))
    call = lambda: K.intersect_dispatch_cuda(a, q, meta, **kw)  # noqa: E731
    ms, old = time_ms(torch, call, 10), enqueue_time_ms(torch, call, 10)
    pms = enqueue_time_ms(torch, lambda: _plain_card_only(
        torch, ref, a, q, meta), 1, warmup=0)
    bound = dispatch_bound(torch, a, q, meta, False)
    N, C = a.shape[0] // q.shape[0], q.shape[0]
    split, lanes = K.stacked_plan(N, C, _n_sm(torch))
    out.append(_row("intersect_dispatch_stacked", launches, err, ms, pms,
                    bound, f"{a.shape[0]} pairs ({live} live) = {N} slabs x "
                    f"{C} query rows, card only; grid {C} x {split} blocks, "
                    f"{lanes} lanes a pair", old_ms=old))

    live, (o, lm, plan), _ = captured["fused_tree"]
    bk, ck = K.fused_eval_cuda(o, lm, plan)
    bp, cp = F.fused_eval_ref(o, lm, plan=plan)
    err = _max_err(torch, (bk, ck), (bp, cp))
    call = lambda: K.fused_eval_cuda(o, lm, plan)  # noqa: E731
    ms, old = time_ms(torch, call, 20), enqueue_time_ms(torch, call, 20)
    pms = enqueue_time_ms(torch, lambda: F.fused_eval_ref(o, lm, plan=plan),
                          3)
    bound = fused_bound(lm.cpu().numpy(), plan.n_ops, o.shape[0], o.shape[1])
    out.append(_row("fused_tree", launches, err, ms, pms, bound,
                    f"{o.shape[0]} operands x {o.shape[1]} columns ({live} "
                    f"live operand rows), {plan.n_ops} word ops", old_ms=old))
    return out


def _n_sm(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def _plain_card_only(torch, ref, a, q, meta, chunk=16384):
    """The plain version over the stacked card-only input, in row chunks
    (the query broadcast to every pair would not fit at once)."""
    C = q.shape[0]
    rows = chunk - chunk % C
    cards = []
    for s in range(0, a.shape[0], rows):
        e = min(a.shape[0], s + rows)
        qq = q.repeat((e - s) // C, 1)
        cards.append(ref.intersect_dispatch_ref(a[s:e], qq,
                                                meta[6 * s:6 * e])[1])
    return torch.cat(cards)


def _max_err(torch, got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError("kernel and plain version differ in shape")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
        err = max(err, int(d))
    if err:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {err})")
    return err


def _row(name, launches, err, ms, pms, bound, shape, library=None,
         old_ms=None):
    src, replaces = KERNELS[name]
    lib_ms, lib_what = library or (None, "none")
    log(f"{name}: {ms:.4f} ms card-opened (host-opened timer {old_ms:.4f} "
        f"ms; plain {pms:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]}, "
        f"{100 * bound[0] / ms:.1f} % of it) at {shape}; launches "
        f"{launches[name]}; library call: {lib_what}"
        + (f" {lib_ms:.4f} ms" if lib_ms else "") + f" ({card_line()})")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms}


# =============================================================================
# the Roaring object API's kernels and the bitmap-index store (SSB)
# =============================================================================

def check_containers(torch, cases, K, ref, seed):
    """The word-op kernel (all four ops) and the packed-array kernel against
    their plain versions on ``cases.container_pairs`` / ``array_pairs``
    (card 0 / 1 / 4095 / 4096, value 65,535, all-ones rows, one EMPTY side,
    both-EMPTY pairs over garbage payload) and on 4,096 random pairs each.
    Exact: every output word and card equal."""
    rng = np.random.default_rng(seed)
    dev = "cuda"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16 if a.dtype == np.uint16 else a.dtype)).to(dev)

    n = 4096
    grids = [cases.container_pairs(rng)]
    kinds = rng.integers(0, 4, 2 * n).astype(np.int32)
    grids.append((rng.integers(0, 1 << 16, (n, 4096)).astype(np.uint16),
                  rng.integers(0, 1 << 16, (n, 4096)).astype(np.uint16),
                  kinds))
    for A, B, kinds in grids:
        a, b, k = t(A), t(B), t(kinds)
        for op in cases.CONTAINER_OPS:
            got = K.container_op_cuda(a, b, k, op)
            torch.cuda.synchronize()
            _same(f"container_op {op}", got,
                  ref.container_op_ref(a, b, k, op))
    grids = [cases.array_pairs(rng)]
    A = np.full((n, 4096), 0xFFFF, np.uint16)
    B = np.full((n, 4096), 0xFFFF, np.uint16)
    cards = rng.integers(0, 4097, 2 * n).astype(np.int32)
    for i in range(n):
        for row, c in ((A[i], cards[2 * i]), (B[i], cards[2 * i + 1])):
            row[:c] = np.sort(rng.choice(1 << 16, c, replace=False))
    grids.append((A, B, cards))
    for A, B, cards in grids:
        a, b, c = t(A), t(B), t(cards)
        got = K.array_intersect_cuda(a, b, c)
        torch.cuda.synchronize()
        _same("array_intersect", got, ref.array_intersect_ref(a, b, c))
    log(f"check container_op: {len(cases.CONTAINER_OPS)} ops x (the case "
        f"grid + {n} random pairs) bit-identical; check array_intersect: "
        f"the case grid + {n} random pairs bit-identical")


def ssb_lineorder(sf, seed):
    """SSB LINEORDER at scale factor ``sf`` (SF x 6,000,000 rows) from the
    spec's column domains: orders of 1-7 lines (TPC-H) in order-key order,
    each with one order date uniform over 1992-01-01 .. 1998-08-02 shared
    by its lines; lo_discount 0-10 and lo_quantity 1-50 uniform per line;
    lo_extendedprice = lo_quantity x P_RETAILPRICE (cents) of a uniform
    part key among SF's 200,000 x (1 + log2 SF) parts. The date columns are
    the DATE dimension's d_year, d_yearmonthnum, d_weeknuminyear."""
    n_rows = int(round(sf * SSB_ROWS_PER_SF))
    rng = np.random.default_rng(seed)
    lines = rng.integers(1, 8, n_rows // 4 + 1024)
    while lines.sum() < n_rows:
        lines = np.concatenate([lines, rng.integers(1, 8, 1024)])
    lines = lines[:int(np.searchsorted(np.cumsum(lines), n_rows)) + 1]
    day = SSB_FIRST_DAY + rng.integers(0, SSB_DAYS, lines.size)
    year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    month = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    week = (day - day.astype("datetime64[Y]")).astype(np.int64) // 7 + 1

    def per_line(x):
        return np.repeat(x, lines)[:n_rows]

    n_parts = 200_000 * int(1 + np.log2(max(sf, 1)))
    partkey = rng.integers(1, n_parts + 1, n_rows)
    quantity = rng.integers(1, 51, n_rows)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)
    return {"lo_year": per_line(year),
            "lo_yearmonthnum": per_line(year * 100 + month),
            "lo_weeknuminyear": per_line(week),
            "lo_discount": rng.integers(0, 11, n_rows),
            "lo_quantity": quantity,
            "lo_extendedprice": quantity * retail}


def ssb_queries(ST):
    """SSB's Q1 flight (O'Neil et al., rev. 3, section 3.1) over LINEORDER:
    name -> (store predicate, numpy row filter)."""
    def between(r, col, lo, hi):
        return (r[col] >= lo) & (r[col] <= hi)

    return {
        "Q1.1": (ST.and_(ST.eq("lo_year", 1993),
                         ST.range_("lo_discount", 1, 3),
                         ST.range_("lo_quantity", None, 24)),
                 lambda r: (r["lo_year"] == 1993)
                 & between(r, "lo_discount", 1, 3) & (r["lo_quantity"] < 25)),
        "Q1.2": (ST.and_(ST.eq("lo_yearmonthnum", 199401),
                         ST.range_("lo_discount", 4, 6),
                         ST.range_("lo_quantity", 26, 35)),
                 lambda r: (r["lo_yearmonthnum"] == 199401)
                 & between(r, "lo_discount", 4, 6)
                 & between(r, "lo_quantity", 26, 35)),
        "Q1.3": (ST.and_(ST.eq("lo_weeknuminyear", 6),
                         ST.eq("lo_year", 1994),
                         ST.range_("lo_discount", 5, 7),
                         ST.range_("lo_quantity", 26, 35)),
                 lambda r: (r["lo_weeknuminyear"] == 6)
                 & (r["lo_year"] == 1994) & between(r, "lo_discount", 5, 7)
                 & between(r, "lo_quantity", 26, 35)),
    }


def store_path(torch, ST, K, ref, F, pr, FS, sf, seed, device="cuda"):
    """SSB LINEORDER as a bitmap index on the card: build, the Q1 flight
    fused and per-op (count, rows, sum of lo_extendedprice) against a numpy
    row filter of the same records, each ``sum_`` launch of the card-only
    kernel and each query's fused launch against its plain version, a
    closed-loop fused count rate per query, and a save -> load(check=True)
    -> save round trip. Returns the store, its records and the fused
    launches' readings (``store_fused_rows``)."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    card = card_line() if device == "cuda" else device
    t = time.perf_counter()
    records = ssb_lineorder(sf, seed)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    store = ST.BitmapStore.build(records, bsi=SSB_BSI, device=device)
    sync()
    t_build = time.perf_counter() - t
    st = store._stack
    kinds = np.bincount(st.kinds.cpu().numpy().ravel(), minlength=4)
    log(f"ssb: LINEORDER SF {sf} = {store.n_rows} rows; {store!r}; stack "
        f"{tuple(st.payload.shape)} = {st.payload.numel() * 2 / 1e9:.3f} GB "
        f"on the card; containers empty/array/bitmap/run = {kinds.tolist()}"
        f"; records {t_gen:.1f} s, build {t_build:.1f} s (host build and "
        f"copy; {card})")
    queries = ssb_queries(ST)
    K.reset_launch_counts()
    per_query = {}
    answers = {}
    timings = {}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        sync()
        timings[key] = (time.perf_counter() - t) * 1e3
        return out

    sums = []                      # each sum_ launch as the kernel got it
    first_fused = {}               # each query's first fused launch
    launch, fused_launch = K.intersect_dispatch_cuda, K.fused_eval_cuda

    def capture(a, b, meta, **kw):
        if not kw.get("want_hits", True):
            sums.append((a, b, meta, dict(kw)))
        return launch(a, b, meta, **kw)

    def capture_fused(ops_, meta, plan, **kw):
        first_fused.setdefault(name, (ops_, meta, plan))
        return fused_launch(ops_, meta, plan, **kw)
    K.intersect_dispatch_cuda = capture
    K.fused_eval_cuda = capture_fused
    try:
        for name, (pred, _) in queries.items():
            answers[name], per_query[name] = _store_answers(
                K, store, name, pred, timed)
    finally:
        K.intersect_dispatch_cuda, K.fused_eval_cuda = launch, fused_launch
    launches = dict(K.launch_counts)
    for name, (_, mask) in queries.items():
        ids = np.nonzero(mask(records))[0]
        want = pr.RoaringBitmap.from_sorted_unique(ids).run_optimize()
        want_bytes = FS.serialize(want)
        got = answers[name]
        for fused in (True, False):
            if got[("count", fused)] != ids.size:
                raise AssertionError(f"{name}: count (fused={fused}) "
                                     "differs from the row filter")
            if got[("rows", fused)] != want_bytes:
                raise AssertionError(f"{name}: rows (fused={fused}) differ "
                                     "from the row filter's bytes")
        want_sum = int(records["lo_extendedprice"][ids].sum())
        if got["sum"] != want_sum:
            raise AssertionError(f"{name}: sum {got['sum']} != {want_sum}")
        log(f"{name}: {ids.size} rows, sum(lo_extendedprice) = {want_sum} "
            "(SSB aggregates sum(lo_extendedprice * lo_discount), which the "
            "store cannot express; this is the sum of one column); fused "
            "and per-op rows byte-identical to the numpy row filter; "
            f"launches {per_query[name]}; first calls (plan compile "
            "included), ms: " + ", ".join(
                f"{what} {'fused' if fused else 'per-op'} "
                f"{timings[(name, what, fused)]:.1f}"
                for fused in (True, False) for what in ("count", "rows"))
            + f", sum_ {timings[(name, 'sum')]:.1f} ({card})")
    for name in SEARCH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "store path")
    log(f"launches on the store path: {launches}")
    fused_rows = []
    if device == "cuda":
        check_sums(torch, K, ref, sums, card)
        fused_rows = store_fused_rows(torch, K, F, first_fused, card)
    for name, (pred, _) in queries.items():
        n, t = 0, time.perf_counter()
        while time.perf_counter() - t < SSB_RATE_S:
            store.count(pred, fused=True)
            n += 1
        dt = time.perf_counter() - t
        log(f"{name} fused count, closed loop: {n} in {dt:.2f} s = "
            f"{n / dt:.1f} QPS ({card})")
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            for _ in range(100):
                for pred, _ in queries.values():
                    store.count(pred, fused=True)
            sync()
            wall_ms = (time.perf_counter() - t) * 1e3
        log(f"profile store: {100 * len(queries)} fused counts (Q1.1-Q1.3 "
            f"in turn), wall {wall_ms:.1f} ms; {device_summary(p, wall_ms)} "
            f"({card})")
    stats = store.cache_stats()
    if stats["fallbacks"]:
        raise AssertionError("a store query took the uncompiled fallback")
    t = time.perf_counter()
    blob = store.save()
    t_save = time.perf_counter() - t
    t = time.perf_counter()
    cells = store.n_slabs * store.n_chunks
    again = ST.BitmapStore.load(blob, check=True, max_stack_cells=cells,
                                device=device)
    t_load = time.perf_counter() - t
    if again.save() != blob:
        raise AssertionError("save -> load(check=True) -> save differs")
    del again
    log(f"save {len(blob)} bytes in {t_save:.1f} s; load(check=True, "
        f"max_stack_cells={cells}) in {t_load:.1f} s re-saves "
        f"byte-identically; plan cache {stats}")
    return store, records, fused_rows


def _store_answers(K, store, name, pred, timed):
    """One SSB query's count and rows, fused and per-op, and its sum_, each
    timed as a first call; returns (answers, launches per kernel)."""
    before = dict(K.launch_counts)
    got = {}
    for fused in (True, False):
        n0 = K.launch_counts["fused_tree"]
        got[("count", fused)] = timed(
            (name, "count", fused), lambda: store.count(pred, fused=fused))
        got[("rows", fused)] = timed(
            (name, "rows", fused),
            lambda: store.query(pred, fused=fused).serialize())
        if fused and K.launch_counts["fused_tree"] - n0 != 2:
            raise AssertionError(f"{name}: a fused query is one fused_tree "
                                 "launch")
    got["sum"] = timed((name, "sum"), lambda: store.sum_(
        "lo_extendedprice", pred))
    return got, {k: v - before[k] for k, v in K.launch_counts.items()
                 if v - before[k]}


def check_sums(torch, K, ref, sums, card):
    """Each card-only launch that ``sum_`` made (bit slices x chunks against
    the predicate's rows) against its plain version, bit for bit; the
    largest timed."""
    for a, q, meta, kw in sums:
        _, got = K.intersect_dispatch_cuda(a, q, meta, **kw)
        _max_err(torch, (got,), (_plain_card_only(torch, ref, a, q, meta),))
    a, q, meta, kw = max(sums, key=lambda x: x[0].shape[0])
    call = lambda: K.intersect_dispatch_cuda(a, q, meta, **kw)  # noqa: E731
    ms, old = time_ms(torch, call, 20), enqueue_time_ms(torch, call, 20)
    bound = dispatch_bound(torch, a, q, meta, False)
    N, C = a.shape[0] // q.shape[0], q.shape[0]
    shapes = ", ".join(f"{x[0].shape[0] // x[1].shape[0]} x {x[1].shape[0]}"
                       for x in sums)
    log(f"store sum_: {len(sums)} card-only launches of "
        f"intersect_dispatch_stacked ({shapes} slices x chunks) "
        "bit-identical to the plain version; the largest, (grid split, "
        f"lanes a pair) {K.stacked_plan(N, C, _n_sm(torch))}: {ms:.4f} ms "
        f"card-opened (host-opened timer {old:.4f} ms), bound "
        f"{bound[0]:.4f} ms by {bound[1]} ({100 * bound[0] / ms:.1f} % of "
        f"it) ({card})")


def store_fused_rows(torch, K, F, fused, card):
    """Each SSB query's fused launch (its operand rows, meta and plan as
    the kernel got them) against its plain version bit for bit, timed warm
    and with L2 flushed, beside the plain version and its bound: one
    reading a query, logged and returned."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    out = []
    for name, (o, lm, plan) in fused.items():
        got = K.fused_eval_cuda(o, lm, plan)
        err = _max_err(torch, got, F.fused_eval_ref(o, lm, plan=plan))
        call = lambda: K.fused_eval_cuda(o, lm, plan)  # noqa: E731
        ms, cold = time_ms(torch, call, 20), time_cold_ms(torch, call, 10,
                                                          flush)
        pms = enqueue_time_ms(torch, lambda: F.fused_eval_ref(
            o, lm, plan=plan), 2)
        bound = fused_bound(lm.cpu().numpy(), plan.n_ops, o.shape[0],
                            o.shape[1])
        lifts = len(F.kernel_program(plan)[0])
        shape = K.fused_launch_shape(lifts, plan.n_slots,
                                     *K.fused_smem(o.device))
        n_live = int((lm[3 * o.shape[0] * o.shape[1]:] != 0).sum())
        log(f"store fused_tree {name}: {ms:.4f} ms warm, {cold:.4f} ms "
            f"cold L2 (plain {pms:.3f} ms, bound {bound[0]:.4f} ms by "
            f"{bound[1]}, {100 * bound[0] / ms:.1f} % of it warm) at "
            f"{o.shape[0]} operands ({lifts} distinct) x {o.shape[1]} "
            f"columns ({n_live} live), {plan.n_loads} loads and "
            f"{plan.n_ops} word ops in {plan.n_slots} slots; (split, stack "
            f"rows, in shared memory) {shape}; bit-identical ({card})")
        out.append({"query": name, "max_abs_err": err, "ms": ms,
                    "cold_ms": cold, "plain_ms": pms, "bound_ms": bound[0],
                    "bound_by": bound[1]})
    return out


def _plain_chunks(torch, fn, n, chunk=32768):
    """A plain version over ``n`` rows in row chunks (its intermediates at
    once would not fit beside the store); outputs concatenated."""
    outs = [fn(slice(s, min(n, s + chunk))) for s in range(0, n, chunk)]
    return tuple(torch.cat(x) for x in zip(*outs))


def month_week_arrays(torch, tr, store):
    """The SSB month x week pairs of the packed-array kernel: the rows of
    each lo_yearmonthnum slab against those of the lo_weeknuminyear slab of
    that month's 15th day, in packed-array form (the store keeps them as
    run rows where best-of-three says so). Returns (A, B int16[80 C, 4096],
    cards i32[2 * 80 C] interleaved, {month: week}, rows stored as runs)."""
    st = store._stack
    ym = store.column("lo_yearmonthnum")
    wk = store.column("lo_weeknuminyear")
    week_of = {}
    for v in ym.values:
        day = np.datetime64(f"{v // 100}-{v % 100:02d}-15")
        week_of[v] = int((day - day.astype("datetime64[Y]")).astype(
            np.int64) // 7 + 1)
    sa = torch.arange(ym.base_slot, ym.base_slot + ym.n_slabs,
                      device=st.device)
    sb = torch.tensor([wk.base_slot + wk.values.index(week_of[v])
                       for v in ym.values], device=st.device)

    def as_arrays(slots):
        k, c = st.kinds[slots].reshape(-1), st.cards[slots].reshape(-1)
        d = st.payload[slots].reshape(-1, 4096)
        if bool(((k == tr.KIND_BITMAP) | (c > 4096)).any()):
            raise AssertionError("a month / week row does not fit an array")
        runs = torch.nonzero(k == tr.KIND_RUN).flatten()
        d = d.clone()
        d[runs] = tr.narrow(tr._arrays_from_runs_rows(tr.widen(d[runs]),
                                                      c[runs]))
        return d, c

    ia, ca = as_arrays(sa)
    ib, cb = as_arrays(sb)
    cards = torch.stack([ca, cb], dim=1).reshape(-1).contiguous()
    n_runs = int((st.kinds[sa] == tr.KIND_RUN).sum() +
                 (st.kinds[sb] == tr.KIND_RUN).sum())
    return ia, ib, cards.to(torch.int32), week_of, n_runs


def container_rows(torch, K, ops, ref, tr, store, records):
    """Both kernels through their entry points at the store's own data, then
    against their plain versions and timed with CUDA events.

    container_op: A = the posting rows of slabs 2 .. N-2 lifted to the
    bitmap domain, B = those of slabs 3 .. N-1 (contiguous slices of one
    lifted tensor). array_intersect: the month x week pairs of
    ``month_week_arrays``."""
    st = store._stack
    N, C = st.kinds.shape
    flat_kind = st.kinds.reshape(-1)
    flat_card = st.cards.reshape(-1)
    flat_data = st.payload.reshape(-1, 4096)
    lifted = torch.empty_like(flat_data)
    for s in range(0, N * C, 16384):
        e = min(N * C, s + 16384)
        lifted[s:e] = tr.narrow(tr._lift_rows(flat_data[s:e],
                                              flat_card[s:e],
                                              flat_kind[s:e]))
    a, b = lifted[2 * C:(N - 1) * C], lifted[3 * C:]
    tags = torch.stack([flat_kind[2 * C:(N - 1) * C], flat_kind[3 * C:]],
                       dim=1).reshape(-1).contiguous()

    ia, ib, cards, week_of, n_runs = month_week_arrays(torch, tr, store)
    ym = store.column("lo_yearmonthnum")
    ca, cb = cards[0::2], cards[1::2]
    torch.cuda.synchronize()

    K.reset_launch_counts()
    outs = {op: ops.container_op(a, b, tags, op) for op in CONTAINER_OPS}
    hits, count = ops.array_intersect(ia, ib, cards)
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    for name in ("container_op", "array_intersect"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")

    # the month x week answer through the store's own row filter
    ymv, wkv = records["lo_yearmonthnum"], records["lo_weeknuminyear"]
    want = sum(int(np.count_nonzero((ymv == v) & (wkv == week_of[v])))
               for v in ym.values)
    if int(count.sum()) != want:
        raise AssertionError(f"array_intersect found {int(count.sum())} "
                             f"rows, the row filter {want}")

    rows = []
    # a and b are slices of one lifted tensor (b's row r is a's row r + C):
    # each row of slabs 2 .. N-1 that a live pair reads counts once; every
    # pair writes its 8 kB row and card, reads its two kind tags
    live = (tags[0::2] != 0) | (tags[1::2] != 0)
    n_live = int(live.sum())
    read = torch.zeros(((N - 2) * C,), dtype=torch.bool, device=st.device)
    read[:a.shape[0]] |= live
    read[C:] |= live
    nbytes = int(read.sum()) * 8192 + a.shape[0] * (8192 + 8 + 4)
    bound = _bound(nbytes, n_live * 2048 * 3)
    ms, old, pms, err = [], [], [], 0
    for op in CONTAINER_OPS:
        plain = _plain_chunks(torch, lambda s: ref.container_op_ref(
            a[s], b[s], tags[2 * s.start:2 * s.stop], op), a.shape[0])
        err = max(err, _max_err(torch, outs[op], plain))
        call = lambda: K.container_op_cuda(a, b, tags, op)  # noqa: E731
        ms.append(time_ms(torch, call, 5))
        old.append(enqueue_time_ms(torch, call, 5))
        pms.append(enqueue_time_ms(torch, lambda: _plain_chunks(
            torch, lambda s: ref.container_op_ref(
                a[s], b[s], tags[2 * s.start:2 * s.stop], op),
            a.shape[0]), 1, warmup=0))
        log(f"container_op {op}: {ms[-1]:.4f} ms (host-opened timer "
            f"{old[-1]:.4f} ms), plain {pms[-1]:.3f} ms")
    rows.append(_row("container_op", launches, err, sum(ms) / len(ms),
                     sum(pms) / len(pms), bound,
                     f"{a.shape[0]} row pairs of slabs 2..{N - 2} x "
                     f"3..{N - 1} ({n_live} live), mean of the four ops",
                     old_ms=sum(old) / len(old)))

    plain = ref.array_intersect_ref(ia, ib, cards)
    err = _max_err(torch, (hits, count), plain)
    call = lambda: K.array_intersect_cuda(ia, ib, cards)  # noqa: E731
    ms, old = time_ms(torch, call, 10), enqueue_time_ms(torch, call, 10)
    pms = enqueue_time_ms(torch, lambda: ref.array_intersect_ref(
        ia, ib, cards), 2)
    ca64, cb64 = ca.cpu().numpy().astype(np.int64), \
        cb.cpu().numpy().astype(np.int64)
    nbytes = int((2 * (ca64 + cb64)).sum()) + ia.shape[0] * (8192 + 8 + 4)
    bound = _bound(nbytes, int((ca64 * _log2(cb64)).sum()))
    rows.append(_row("array_intersect", launches, err, ms, pms, bound,
                     f"{ia.shape[0]} row pairs ({ym.n_slabs} months x {C} "
                     f"chunks; mean card {ca64.mean():.0f} x "
                     f"{cb64.mean():.0f}; {n_runs} of {2 * ia.shape[0]} "
                     f"rows stored as runs, fed in packed-array form); "
                     f"{want} rows in month and week", old_ms=old))
    return rows

# =============================================================================
# LM serving on the Roaring-paged KV cache
# =============================================================================

def check_paged_decode(torch, pd_cases, SK, SR, seed):
    """The paged decode kernel against its plain version over
    ``cases.CHECK_GRID`` (G 1 / 2, D 64 / 256, pages of 8 / 16, softcap on
    and off; then every other (G, D) of the registry: 5 / 6 / 8 / 12 with
    D 128, 1 with D 80; then 16 / 128 and 3 / 64 for the tensor-core
    kernel's padding of G to 16, the latter over 3 KV heads), in bf16 and
    f32, on two cases each: rows with ``starts > 0``,
    an empty row (``counts = 0``, which must give zeros) and NaN in every
    page after a row's ``counts``; and rows across the kernel's split
    blocks (a window starting past the first split, a length ending one
    position into a split, ``counts = 0`` and ``starts >= lengths``, the
    last two zeros). Then ``cases.RING_GRID`` on the long-split layout
    (``ring_check``)."""
    rng = np.random.default_rng(seed)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for G, D, page, softcap, KVH in pd_cases.CHECK_GRID:
        for make in (pd_cases.paged_decode_case,
                     pd_cases.paged_decode_split_case):
            c = make(rng, G, D, page, KVH=KVH)
            if make is pd_cases.paged_decode_split_case and any(
                    SK.decode_split(SK.decode_rows(*c["q"].shape, dt),
                                    c["page_idx"].shape[1] * page, n_sm)
                    != pd_cases.DECODE_SPLIT for dt in worst):
                raise AssertionError("the split case no longer crosses the "
                                     "kernel's splits")
            t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
            args = tuple(t[k] for k in ("page_idx", "counts", "lengths",
                                        "starts"))
            empty = torch.from_numpy(pd_cases.no_live_position(c)).cuda()
            for dtype in worst:
                q, kp, vp = (t[k].to(dtype)
                             for k in ("q", "k_pages", "v_pages"))
                got = SK.paged_decode_cuda(q, kp, vp, *args, softcap=softcap)
                want = SR.paged_decode_ref(q, kp, vp, *args, softcap=softcap)
                torch.cuda.synchronize()
                if (got.dtype != dtype or not bool(torch.isfinite(got).all())
                        or bool(got[empty].any())):
                    raise AssertionError(
                        f"paged_decode {make.__name__} G={G} D={D} "
                        f"page={page} {dtype}: non-finite output or a "
                        "non-zero row without live positions")
                err = (got.float() - want.float()).abs().max().item()
                worst[dtype] = max(worst[dtype], err)
    log(f"check paged_decode: {len(pd_cases.CHECK_GRID)} cases x 2 layouts "
        f"(one across {pd_cases.DECODE_SPLIT}-position splits) x (bf16, "
        f"f32); max abs err {worst[torch.bfloat16]:.3g} (bf16, tolerance "
        f"{BF16_ATOL}), {worst[torch.float32]:.3g} (f32, tolerance "
        f"{F32_ATOL}); rows without live positions zero, NaN pages after "
        "counts never read")
    if worst[torch.bfloat16] > BF16_ATOL or worst[torch.float32] > F32_ATOL:
        raise AssertionError("paged_decode disagrees with its plain version")
    ring_check(torch, pd_cases, SK, SR, rng, n_sm)
    return worst[torch.bfloat16]


def ring_check(torch, pd_cases, SK, SR, rng, n_sm):
    """The paged decode kernel against its plain version on
    ``cases.paged_decode_ring_case`` over ``cases.RING_GRID``, in bf16 and
    f32: splits of ``RING_SPLIT`` positions, so each warp refills its ring
    of copies many times. Rows of 531-2,624 live positions give outputs
    near 0.02-0.1, so bf16 is held by ``paged_error`` (LONG_PAGED_ULPS
    ulps of each output vector's largest element; a flat BF16_ATOL would
    pass a kernel that read a stale tile), f32 within F32_ATOL. The plain
    version gets each row's page list cut after the longest row's
    ``counts``: the same function (no position past ``counts`` is live),
    without gathering the half a million dead positions that the kernel's
    page lists hold."""
    dtypes = (torch.bfloat16, torch.float32)
    worst = {dt: (0.0, 0.0, "") for dt in dtypes}    # (err, share, case)
    for G, D, page, softcap, KVH in pd_cases.RING_GRID:
        # enough positions that both dtypes' paths take the longest split
        max_pages = pd_cases.ring_max_pages(
            min(SK.decode_rows(4, KVH, G, D, dt) for dt in dtypes),
            SK.DECODE_BLOCKS_PER_SM * n_sm, page)
        c = pd_cases.paged_decode_ring_case(rng, G, D, page, KVH=KVH,
                                            max_pages=max_pages)
        if any(SK.decode_split(SK.decode_rows(*c["q"].shape, dt),
                               max_pages * page, n_sm)
               != pd_cases.RING_SPLIT for dt in dtypes):
            raise AssertionError("the long-split case no longer takes the "
                                 "kernel's longest split")
        cut = int(c["counts"].max())
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in c.items()}
        args = tuple(t[k] for k in ("page_idx", "counts", "lengths",
                                    "starts"))
        short = (t["page_idx"][:, :cut].contiguous(),) + args[1:]
        for dtype in dtypes:
            q, kp, vp = (t[k].to(dtype) for k in ("q", "k_pages", "v_pages"))
            got = SK.paged_decode_cuda(q, kp, vp, *args, softcap=softcap)
            want = SR.paged_decode_ref(q, kp, vp, *short, softcap=softcap)
            torch.cuda.synchronize()
            if got.dtype != dtype or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"paged_decode ring case G={G} D={D} "
                                     f"{dtype}: non-finite output")
            err, share = paged_error(torch, got, want)
            name = f"G={G} D={D} page={page} KVH={KVH}"
            if share >= worst[dtype][1]:
                worst[dtype] = (err, share, name)
            if share > 1:
                raise AssertionError(
                    f"paged_decode disagrees with its plain version on the "
                    f"long-split case {name} {dtype}: max abs err {err:.4g}, "
                    f"{share:.3g} of its tolerance")
    log(f"check paged_decode, long splits: {len(pd_cases.RING_GRID)} cases "
        f"x (bf16, f32), {pd_cases.RING_SPLIT} positions a split, rows of "
        "531-2,624 live positions; max abs err and the largest share of "
        "its tolerance (bf16: "
        f"{LONG_PAGED_ULPS} ulps of each output vector's largest element; "
        f"f32: {F32_ATOL}): "
        + "; ".join(f"{dt}: {e:.3g}, {r:.3g} ({name})"
                    for dt, (e, r, name) in worst.items()))


def serve_path(torch, T, SV, LS, SK, cfg, seed, device="cuda"):
    """gemma2-2b at full width and depth behind ``ServeEngine``: 8 short
    requests (``launch/serve.py``'s traffic) and one with a prompt past the
    sliding window. Checks every request against greedy over the port's
    own teacher-forced ``forward``, one ``paged_decode`` launch per layer
    per step, and every page back in the pool. Returns what the kernel row
    needs: the launch count, the host page lists of the step with the most
    live positions, and the engine (its pools)."""
    t0 = time.perf_counter()
    cuda = device == "cuda"
    params = T.init_lm(cfg, seed, device=device)
    if cuda:
        torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}; "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f}"
        f" GB ({cfg.param_dtype}, compute {cfg.compute_dtype}); init "
        f"{time.perf_counter() - t0:.1f} s")
    eng = SV.ServeEngine(cfg, params, device=device, **SERVE_ENGINE)
    rng = np.random.default_rng(seed)
    reqs = [SV.Request(req_id=0, prompt=rng.integers(
        1, cfg.vocab, LONG_PROMPT).astype(np.int32),
        max_new_tokens=SERVE_NEW)]
    for r in LS.make_requests(cfg, 8, SERVE_NEW, seed):
        r.req_id += 1
        reqs.append(r)

    # bookkeeping inside the timed run, with no host sync: per step the
    # request it advances and that row's top-2 logits (one small top-k on
    # the card), and the host page lists of the step with the most live
    # positions
    steps, tops, largest = [], [], [0, None]
    orig_advance, orig_batch = eng._advance, eng._batch_arrays
    orig_decode = T.decode_step_paged

    def advance(slot, token, sample):
        steps.append((eng.slots[slot], sample))
        return orig_advance(slot, token, sample)

    def batch_arrays():
        out = orig_batch()
        if int(out[2].sum()) > largest[0]:
            largest[:] = [int(out[2].sum()), tuple(a.copy() for a in out)]
        return out

    def decode(*args, write=None, **kw):
        logits, pools = orig_decode(*args, write=write, **kw)
        rows = torch.nonzero(write).flatten().to(logits.device)
        tops.append(torch.topk(logits[rows, 0].float(), 2))
        return logits, pools

    eng._advance, eng._batch_arrays = advance, batch_arrays
    T.decode_step_paged = decode
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        SK.reset_launch_counts()
        wall, peak_util = LS.serve(eng, reqs)
        launches = dict(SK.launch_counts)
    finally:
        T.decode_step_paged = orig_decode
        del eng._advance, eng._batch_arrays
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    if len(tops) != len(steps):
        raise AssertionError("a step ran no decode")

    n_steps = eng.steps_run
    fed = sum(len(r.prompt) - 1 + len(r.generated) for r in reqs)
    gen = sum(len(r.generated) for r in reqs)
    card = card_line() if cuda else device
    log(f"serve: {len(reqs)} requests (prompts {len(reqs[0].prompt)} and "
        f"{min(len(r.prompt) for r in reqs[1:])}-"
        f"{max(len(r.prompt) for r in reqs[1:])} tokens, {SERVE_NEW} new "
        f"each), max_batch {eng.max_batch}, page_size {eng.page_size}: "
        f"{n_steps} steps ({fed} tokens fed, {gen} generated) in {wall:.2f} "
        f"s = {gen / wall:.2f} generated tokens/s, {fed / wall:.1f} fed "
        f"tokens/s, {1e3 * wall / n_steps:.2f} ms per step; peak page "
        f"utilization {peak_util:.2%}; max_memory_allocated {peak:.2f} GB "
        f"({card})")
    if not all(r.done and len(r.generated) == SERVE_NEW for r in reqs):
        raise AssertionError("a request did not finish")
    if eng.requeues or n_steps != fed:
        raise AssertionError(f"{eng.requeues} requeues, {n_steps} steps for "
                             f"{fed} fed tokens")
    check_greedy(torch, T, cfg, params, reqs, steps, tops)
    want = cfg.n_layers * n_steps
    log(f"launches on the serve path: {launches}; {cfg.n_layers} layers x "
        f"{n_steps} steps = {want}")
    if launches["paged_decode"] != want:
        raise AssertionError("paged_decode was not launched once per layer "
                             "per decode step")
    if eng.table.seq_pages or len(eng.table.free) != eng.table.n_pages:
        raise AssertionError("pages leaked: not every page is back in the "
                             "pool")
    log(f"pages: all {eng.table.n_pages} back in the pool")
    rates = {"steps": n_steps, "wall_s": wall,
             "fed": [len(r.prompt) - 1 + len(r.generated) for r in reqs]}
    return launches, largest[1], eng, params, rates


def check_greedy(torch, T, cfg, params, reqs, steps, tops):
    """Every request's tokens against the port's teacher-forced ``forward``
    of its prompt and its own tokens, at every step: forward's argmax where
    its top-2 gap is at least ``GAP_TOL``, and within the logit tolerance
    (``LOGIT_ULP``, from forward's final hidden state) at a near-tie; the
    engine's top logit within tolerance of forward's logit for the same
    token everywhere."""
    top_vals = torch.cat([t.values for t in tops]).cpu().numpy()
    sampled = {}
    for i, (rid, is_sample) in enumerate(steps):
        if is_sample:
            sampled.setdefault(rid, []).append(i)
    table = (params["embed"] if cfg.tie_embeddings
             else params["unembed"])["table"]
    hidden = []
    unembed = T.common.unembed

    def keep(tbl, x, **kw):             # forward's final hidden state
        hidden.append(x)
        return unembed(tbl, x, **kw)
    exact = total = 0
    near, worst, ratio, tols = [], 0.0, 0.0, []
    t = time.perf_counter()
    long = [r for r in reqs if len(r.prompt) > 512]     # padding the short
    short = [r for r in reqs if len(r.prompt) <= 512]   # ones to it wastes
    for group in (long, short):
        if not group:
            continue
        seqs = [np.concatenate([r.prompt, r.generated[:-1]]) for r in group]
        tokens = np.zeros((len(seqs), max(map(len, seqs))), np.int64)
        for i, sq in enumerate(seqs):       # causal: the tail padding never
            tokens[i, :len(sq)] = sq        # reaches an earlier position
        T.common.unembed = keep
        try:
            logits, _ = T.forward(params, torch.from_numpy(tokens).to(
                table.device), cfg)
        finally:
            T.common.unembed = unembed
        x = hidden.pop()
        for i, r in enumerate(group):
            a = len(r.prompt) - 1
            n = len(r.generated)
            f = logits[i, a:a + n].float()
            top2 = torch.topk(f, 2)
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            arg = top2.indices[:, 0]
            tok = torch.as_tensor(r.generated, device=f.device)
            at_tok = f.gather(1, tok[:, None])[:, 0]
            xa = x[i, a:a + n].float().abs()
            tol_tok, tol_top = (LOGIT_ULP * (xa * table[v].abs()).sum(
                1).cpu().numpy() for v in (tok, arg))
            behind = (top2.values[:, 0] - at_tok).cpu().numpy()
            at_tok, arg = at_tok.cpu().numpy(), arg.cpu().numpy()
            eng_top = top_vals[sampled[r.req_id], 0]
            off = np.abs(eng_top - at_tok)
            worst = max(worst, float(off.max()))
            ratio = max(ratio, float((off / tol_tok).max()))
            tols += list(tol_tok)
            total += n
            for k, g in enumerate(r.generated):
                if off[k] > tol_tok[k]:
                    raise AssertionError(
                        f"request {r.req_id} step {k}: engine top logit "
                        f"{eng_top[k]:.6g}, forward's logit for its token "
                        f"{at_tok[k]:.6g}, beyond the tolerance "
                        f"{tol_tok[k]:.4g}")
                if gap[k] >= GAP_TOL:
                    if g != int(arg[k]):
                        raise AssertionError(
                            f"request {r.req_id} step {k}: engine token {g},"
                            f" teacher-forced greedy {int(arg[k])} (top-2 "
                            f"gap {gap[k]:.4g}, engine top logit "
                            f"{eng_top[k]:.4g}, forward's logit for it "
                            f"{at_tok[k]:.4g})")
                    exact += 1
                    continue
                if behind[k] > tol_top[k] + tol_tok[k]:
                    raise AssertionError(
                        f"request {r.req_id} step {k}: a near-tie (gap "
                        f"{gap[k]:.4g}) where forward's logit for the "
                        f"engine's token {g} is {behind[k]:.4g} below its "
                        f"top, beyond the tolerance "
                        f"{tol_top[k] + tol_tok[k]:.4g}")
                near.append((r.req_id, k, round(float(gap[k]), 5),
                             round(float(behind[k]), 5),
                             round(float(tol_top[k] + tol_tok[k]), 5)))
        del logits, x
    log(f"greedy: all {total} steps compared; {exact} with a top-2 gap of "
        f"at least {GAP_TOL} equal forward's argmax; {len(near)} near-ties "
        "within tolerance (request, step, gap, forward's top logit minus "
        f"its logit for the engine's token, tolerance): {near}; max "
        f"|engine top logit - forward logit for that token| {worst:.4g}, "
        f"at most {ratio:.3f} of its tolerance (tolerances "
        f"{min(tols):.4g}-{max(tols):.4g}: one bf16 ulp, "
        f"{LOGIT_ULP}, of each element of forward's final hidden state); "
        f"forward {time.perf_counter() - t:.1f} s")


def device_summary(prof, wall_ms, top_n=6) -> str:
    """Device busy time (kernels and copies; one stream) of a profiled
    window against its wall time, and the work that takes the most."""
    from torch.autograd import DeviceType
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:top_n]
    return (f"device busy {busy:.2f} ms = {100 * busy / wall_ms:.1f} % of "
            f"wall (idle {100 - 100 * busy / wall_ms:.1f} %); top device "
            "work: " + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
            if busy > 0 else "device time not measured (the profiler saw "
            "no device activity)")


def serve_profile(torch, SV, LS, obs, cfg, params, eng, seed):
    """One warm window of 4 short requests under ``torch.profiler`` with
    the engine's spans on: the ``serve.step`` host time, device busy time
    (kernels and copies; one stream) against the window's wall time, and
    the work that takes the device time. The profiler and the spans add
    host time, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    LS.serve(eng, LS.make_requests(cfg, 2, 8, seed + 1))       # warm
    obs.reset_traces()
    reqs = LS.make_requests(cfg, 4, 8, seed + 2)
    steps = eng.steps_run
    with obs.telemetry_scope(True), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        wall, _ = LS.serve(eng, reqs)
    n = eng.steps_run - steps
    span_ms = sum(sp.duration_s for sp in obs.span_trees()
                  if sp.name == "serve.step") * 1e3
    wall_ms = wall * 1e3
    device = device_summary(p, wall_ms)
    log(f"profile serve ({cfg.name}): 4 requests in {n} steps, wall "
        f"{wall_ms:.1f} ms "
        f"({wall_ms / n:.2f} ms per step); serve.step spans {span_ms:.1f} "
        f"ms; {device} ({card_line()})")


def _leaves(tree):
    """Leaves of nested dicts / lists; dicts by sorted key, so two trees of
    one structure line up whatever order their keys were inserted in."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def kernel_regs(report, key):
    """Registers a thread and spilled bytes of the one kernel instantiation
    whose mangled name holds ``key``, from ``build.ptxas_report``."""
    hits = [v for name, v in report.items() if key in name]
    if len(hits) != 1:
        return "registers not reported"
    return f"{hits[0][0]} registers a thread, {hits[0][1]} bytes spilled"


def paged_decode_bound(q, page_idx, counts, kv_len, starts, page_size):
    """(bound_ms, bound_by) of one paged decode launch: each live position's
    K and V rows read once, each page id of a live page, q and the
    per-row scalars read once, out written once; QK and PV at 2 operations
    per multiply-add over the bf16 tensor-core peak."""
    B, KVH, G, D = q.shape
    item = q.element_size()
    lo = np.maximum(starts, 0)
    hi = np.minimum(kv_len, counts * page_size)
    live = np.maximum(hi - lo, 0)
    pages = np.where(hi > lo, -(-hi // page_size) - lo // page_size, 0)
    nbytes = (int(live.sum()) * 2 * KVH * D * item + 2 * B * KVH * G * D * item
              + 4 * int(pages.sum()) + 12 * B)
    ops = int(live.sum()) * KVH * G * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            int(live.sum()))


def paged_error(torch, got, want):
    """(max abs err, largest share of its tolerance) of a paged decode
    output [..., D] against its plain version. bf16: each output vector
    within LONG_PAGED_ULPS bf16 ulps of its own largest element (both
    sides round an f32 result to bf16, so they may differ by one ulp of
    an element; a softmax over 32,768 random rows gives outputs near 0.01,
    where a flat BF16_ATOL would hold nothing), and a vector of zeros
    exactly. f32: within F32_ATOL."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if want.dtype != torch.bfloat16:
        return err, err / F32_ATOL
    top = want.float().abs().amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126)))
                     - 7)
    tol = torch.where(top > 0, LONG_PAGED_ULPS * ulp, 0.0)
    # 0 / 0 where both are zero; any difference from zeros is infinite
    share = (diff / tol).nan_to_num(nan=0.0, posinf=math.inf)
    return err, share.max().item()


def measure_paged_decode(torch, SK, SR, q, kp, vp, page_idx, counts, kv_len,
                         starts, softcap, iters, flush):
    """Kernel, plain version and the library yardstick on one input: the
    max abs error, their ms, the bound and the live positions. The
    yardstick is ``scaled_dot_product_attention`` over K / V gathered into
    contiguous [B, KVH, L, D] beforehand (the gather is not timed: no
    single call does the page indirection) with the live mask, and without
    the softcap, which it cannot apply."""
    import torch.nn.functional as Fn
    ps = kp.shape[1]
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()
         for k, v in (("page_idx", page_idx), ("counts", counts),
                      ("kv_len", kv_len), ("starts", starts))}
    args = (q, kp, vp, t["page_idx"], t["counts"], t["kv_len"], t["starts"])
    got = SK.paged_decode_cuda(*args, softcap=softcap)
    want = SR.paged_decode_ref(*args, softcap=softcap)
    err, share = paged_error(torch, got, want)
    if share > 1:
        raise AssertionError(f"paged_decode disagrees with its plain version "
                             f"(max abs err {err:.4g}, {share:.3g} of its "
                             "tolerance)")
    del got, want
    call = lambda: SK.paged_decode_cuda(*args, softcap=softcap)  # noqa
    for _ in range(WARM_CALLS):
        call()
    torch.cuda.synchronize()
    ms = time_cold_ms(torch, call, iters, flush)
    old = enqueue_time_cold_ms(torch, call, iters, flush)
    pms = enqueue_time_cold_ms(torch, lambda: SR.paged_decode_ref(
        *args, softcap=softcap), max(2, iters // 10), flush)
    B, KVH, G, D = q.shape
    L = int(counts.max()) * ps
    pidx = t["page_idx"][:, :int(counts.max())].long()
    k_seq = kp[pidx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
    v_seq = vp[pidx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
    pos = torch.arange(L, device=q.device)
    live = ((pos[None] < t["kv_len"][:, None])
            & (pos[None] >= t["starts"][:, None])
            & (pos[None] < t["counts"][:, None] * ps))
    mask = None if bool(live.all()) else live[:, None, None, :]
    qh = q.reshape(B, KVH * G, 1, D)
    lib = time_cold_ms(torch, lambda: Fn.scaled_dot_product_attention(
        qh, k_seq, v_seq, attn_mask=mask, enable_gqa=True), iters, flush)
    del k_seq, v_seq
    bound, n_live = paged_decode_bound(q, page_idx, counts, kv_len, starts,
                                       ps)
    return err, share, ms, old, pms, lib, bound, n_live


def paged_decode_rows(torch, SK, SR, cfg, eng, largest, launches, seed,
                      regs):
    """The paged decode kernel at the serve path's largest launch (the
    step with the most live positions, on a global layer, against the
    engine's own pools; q drawn from a seed), and at ``decode_32k``'s
    shape for one layer with the batch cut from 128 to 32; with the split
    length each took and the split kernel's registers (``regs``, from
    ``build.ptxas_report``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    B, KVH, hd = eng.max_batch, cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KVH
    j = cfg.block_kinds().index("attn_mlp")              # a global layer
    dt = eng.pools[j]["k"].dtype
    (err, share, ms, old, pms, lib, bound, n_live), kv_len, splits = \
        largest_launch(torch, SK, SR, cfg, eng, largest, j, gen, flush)
    kg = 1 << (G - 1).bit_length()       # the kernel's head-count class
    log(f"paged_decode CUDA-core split kernel (bf16, G = {G}, D = {hd}): "
        f"{kernel_regs(regs, f'split_kernelI13__nv_bfloat16Li{kg}ELi1E')}; "
        f"combine: {kernel_regs(regs, 'combine_kernelI13__nv_bfloat16E')}; "
        "tensor-core split kernel (bf16) at D = "
        + "; ".join(f"{d}: {kernel_regs(regs, f'mma_split_kernelILi{d}E')}"
                    for d in SK.DECODE_MMA_HEAD_DIMS))
    row = _row("paged_decode", launches, err, ms, pms, bound,
               f"the serve path's largest launch: B = {B}, KVH = {KVH}, G = "
               f"{G}, D = {hd}, page {eng.page_size}, lengths "
               f"{kv_len.tolist()} ({n_live} live positions), bf16, softcap "
               f"{cfg.attn_softcap}, "
               f"{splits}; "
               f"cold L2; max abs err {err:.3g}, {share:.3g} of its "
               "tolerance",
               (lib, "scaled_dot_product_attention (gather excluded, no "
                "softcap)"), old_ms=old)

    decode_32k(torch, SK, SR, gen, flush, "one global layer", KVH, G, hd,
               dt, cfg.attn_softcap)
    return row


def largest_launch(torch, SK, SR, cfg, eng, largest, j, gen, flush):
    """``measure_paged_decode`` at a serve path's largest launch (its host
    page lists ``largest``) against the engine's pools of block kind ``j``
    (the first super-block's), q drawn from ``gen``; with the launch's
    lengths and its split."""
    B, KVH, hd = eng.max_batch, cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KVH
    dt = eng.pools[j]["k"].dtype
    page_idx, counts, lengths, _ = largest
    kv_len = np.maximum(lengths - 1, 0) + 1
    q = torch.randn((B, KVH, G, hd), generator=gen, device="cuda").to(dt)
    out = measure_paged_decode(
        torch, SK, SR, q, eng.pools[j]["k"][0], eng.pools[j]["v"][0],
        page_idx, counts, kv_len, np.zeros_like(kv_len), cfg.attn_softcap,
        50, flush)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = SK.decode_rows(B, KVH, G, hd, dt)
    positions = page_idx.shape[1] * eng.page_size
    n = SK.decode_split(rows, positions, n_sm)
    return out, kv_len, (f"{n} positions a split, "
                         f"{rows * -(-positions // n)} split blocks")


def decode_32k(torch, SK, SR, gen, flush, what, KVH, G, D, dt, softcap,
               Bc=32):
    """The paged decode kernel at ``decode_32k``'s shape for one layer
    with the batch cut from 128 to ``Bc`` (32,768 positions a sequence,
    pages of 16, random page lists and K / V from ``gen``): its time, the
    plain version's, the bound and ``scaled_dot_product_attention``'s,
    logged and returned as a dict."""
    L, ps = 32_768, 16
    n_pp = L // ps
    P = Bc * n_pp
    pidx = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    pidx = pidx.reshape(Bc, n_pp).cpu().numpy()
    kp, vp = (torch.randn((P, ps, KVH, D), generator=gen, device="cuda",
                          dtype=dt) for _ in range(2))
    q = torch.randn((Bc, KVH, G, D), generator=gen, device="cuda").to(dt)
    full = np.full((Bc,), L, np.int32)
    err, share, ms, old, pms, lib, bound, n_live = measure_paged_decode(
        torch, SK, SR, q, kp, vp, pidx, np.full((Bc,), n_pp, np.int32), full,
        np.zeros_like(full), softcap, 10, flush)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = SK.decode_rows(Bc, KVH, G, D, dt)
    split = SK.decode_split(rows, L, n_sm)
    mma = dt == torch.bfloat16 and D in SK.DECODE_MMA_HEAD_DIMS
    log(f"paged_decode at decode_32k, {what} (KVH {KVH}, G {G}, D {D}, {dt}; "
        f"{'tensor-core' if mma else 'CUDA-core'} kernel), batch cut from "
        f"128 to {Bc} "
        f"(KV {L} tokens, pools "
        f"{2 * kp.numel() * kp.element_size() / 1e9:.2f} GB): {ms:.4f} ms "
        f"card-opened (host-opened timer {old:.4f} ms; plain {pms:.3f} ms, "
        f"bound {bound[0]:.4f} ms by {bound[1]}, "
        f"{100 * bound[0] / ms:.1f} % of it; scaled_dot_product_attention "
        f"{lib:.4f} ms with the gather excluded and no softcap); max abs "
        f"err {err:.3g}, {share:.3g} of its tolerance ({LONG_PAGED_ULPS} "
        f"bf16 ulps of each output vector's largest element); {n_live} "
        f"live positions, {split} positions a "
        f"split, {rows * -(-L // split)} split blocks "
        f"({card_line()})")
    return {"KVH": KVH, "G": G, "D": D, "batch": Bc, "kv_len": L, "ms": ms,
            "plain_ms": pms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib, "max_abs_err": err}


# =============================================================================
# serving the rest of the registry: dbrx-132b (MoE) at full width on the
# paged cache, rwkv6-1.6b and whisper-base over state / dense caches, and
# the other reduced configs against their CPU runs
# =============================================================================

def paged_decode_registry(torch, SK, SR, seed):
    """The paged decode kernel at ``decode_32k`` (``decode_32k``), bf16, no
    softcap, at every (KVH, G, D) that the paged engine serves in the
    registry other than gemma2-2b's (``paged_decode_rows`` measures it):
    dbrx-132b's (8, 6, 128), starcoder2-15b's (4, 12, 128) and the rest,
    one entry a shape, named by its archs."""
    from repro_torch.configs import get_config, list_archs
    shapes = {}
    for arch in list_archs():
        c = get_config(arch)
        if (arch != SERVE_ARCH
                and all(k.startswith("attn") for k in c.block_kinds())):
            key = (c.n_kv_heads, c.n_heads // c.n_kv_heads, c.hd)
            shapes.setdefault(key, []).append(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    out = {}
    for (KVH, G, D), archs in shapes.items():
        name = " / ".join(archs)
        out[name] = decode_32k(torch, SK, SR, gen, flush, f"{name}'s heads",
                               KVH, G, D, torch.bfloat16, None)
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def _route_spy(torch, PM, into, force=None):
    """Wrap ``mlp.route`` so each call appends (the chosen experts as a
    bool [N, E], the kept (token, expert) pairs as a bool [N, E], the gap
    between each token's k-th and (k+1)-th router probability, the router
    probabilities, route's output) to ``into``; returns the function that
    unwraps it. The order of the k experts inside a token's top k changes
    no slot (a token's pairs go to distinct experts), so it is not
    compared. With ``force`` (another run's ``into``), the i-th call
    routes as that run's i-th did: its gate indices, slots and keep mask,
    with gate values from this call's own probabilities at those indices,
    normalised as ``route`` does; ``into`` still records this call's own
    choice."""
    orig = PM.route

    def spy(router, x, cfg, G=1):
        out = orig(router, x, cfg, G)
        probs, _, gate_idx, _, keep, C = out
        N, E = probs.shape
        tok = torch.arange(N, device=probs.device).repeat_interleave(
            cfg.top_k)
        chosen = torch.zeros((N, E), dtype=torch.bool, device=probs.device)
        chosen[tok, gate_idx.reshape(-1)] = True
        kept = torch.zeros_like(chosen)
        kept[tok, gate_idx.reshape(-1)] = keep.reshape(-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        into.append((chosen, kept,
                     top[:, cfg.top_k - 1] - top[:, cfg.top_k], probs, out))
        if force is not None:
            _, _, f_idx, f_slot, f_keep, f_C = force[len(into) - 1][4]
            if f_C != C:
                raise AssertionError(f"forced routing of capacity {f_C} "
                                     f"on a call of capacity {C}")
            vals = torch.gather(probs, 1, f_idx)
            vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
            out = (probs, vals, f_idx, f_slot, f_keep, C)
        return out
    PM.route = spy

    def undo():
        PM.route = orig
    return undo


def _dense_from_pools(torch, pools, page_idx, counts):
    """Dense per-row caches [n_sb, B, max_pages * page, KVH, hd] gathered
    from the paged pools through each row's page list; positions past a
    row's ``counts`` pages hold zeros."""
    out = []
    for pool in pools:
        n_sb, _, ps = pool["k"].shape[:3]
        B, mp = page_idx.shape
        live = (torch.arange(mp * ps, device=page_idx.device)[None]
                < counts[:, None].long() * ps)                  # [B, L]
        c = {}
        for k in ("k", "v"):
            g = pool[k][:, page_idx.long()].reshape(n_sb, B, mp * ps,
                                                    *pool[k].shape[3:])
            c[k] = g * live[None, :, :, None, None].to(g.dtype)
        out.append(c)
    return out


def dbrx_path(torch, T, PM, SV, LS, SK, SR, obs, seed, device="cuda",
              cfg=None):
    """dbrx-132b at full width (8 of its 40 layers) behind ``ServeEngine``
    on the paged cache, through the paged decode kernel at G = 6, D = 128.

    A MoE's output depends on the batch it is routed with (capacity per
    group), so teacher-forced ``forward`` is no oracle. Run 1 is timed.
    Run 2 serves the same requests again and, after each engine step,
    runs the dense-cache ``decode_step`` over the same batch rows, tokens,
    positions and write mask, from caches gathered out of the engine's
    pools, so its MoE routes the same tokens, and each of its layers
    takes the engine layer's experts, slots and keep mask
    (``_route_spy(force=)``). Every step's written row's logits are held
    to the dense step's with the serving phase's tol(v) and near-tie rule;
    every layer's router probabilities agree within ``ROUTER_DRIFT``; a
    row for which the replay's own top k differs from the engine's is a
    router near-tie (its k-th and (k+1)-th probability within
    ``ROUTER_TIE``) and is counted. Both runs give the same tokens; every
    page returns.
    Between the two, ``serve_profile`` profiles a warm window of the timed
    run's engine. After them, the paged decode kernel is timed at the
    checked run's largest launch (the step with the most live positions)
    against that engine's own pools. ``device`` / ``cfg`` rehearse it on
    the CPU at a reduced config (no profile, no timing)."""
    from repro_torch.configs import get_config
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cfg is None:
        cfg = dataclasses.replace(get_config(DBRX_ARCH),
                                  n_layers=DBRX_LAYERS)
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed, device=device)
    sync()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    per_layer = sum(t.numel() * t.element_size()
                    for t in _leaves(params["blocks"])) / n_layers
    log(f"CUT: {cfg.name} at full width with {n_layers} of its 40 "
        f"layers: {nbytes / 1e9:.2f} GB of {cfg.param_dtype} weights "
        f"({per_layer / 1e9:.2f} GB a layer, "
        f"{params['embed']['table'].numel() * 2 / 1e9:.2f} GB tied "
        f"embedding); 40 layers would need "
        f"{(nbytes + 32 * per_layer) / 1e9:.1f} GB of the card's 80 GB. "
        f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
        f"{cfg.hd}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; init "
        f"{time.perf_counter() - t0:.1f} s")

    def run(checked):
        eng = SV.ServeEngine(cfg, params, device=device, **DBRX_ENGINE)
        reqs = LS.make_requests(cfg, DBRX_REQUESTS, SERVE_NEW, seed)
        if not checked:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            SK.reset_launch_counts()
            wall, _ = LS.serve(eng, reqs)
            return eng, reqs, wall, dict(SK.launch_counts)
        stats = {"steps": 0, "exact": 0, "logit_ties": [], "router_ties": [],
                 "ratio": 0.0, "noise": 0.0, "tie_gap": 0.0,
                 "largest": [0, None]}
        orig = T.decode_step_paged
        orig_batch = eng._batch_arrays

        def batch_arrays():
            out = orig_batch()
            if int(out[2].sum()) > stats["largest"][0]:
                stats["largest"] = [int(out[2].sum()),
                                    tuple(a.copy() for a in out)]
            return out
        eng._batch_arrays = batch_arrays

        def decode(params_, pools, tok, pos, page_idx, counts, lengths, cfg_,
                   write=None):
            eng_routes, dense_routes, hidden = [], [], []
            undo = _route_spy(torch, PM, eng_routes)
            try:
                logits, pools = orig(params_, pools, tok, pos, page_idx,
                                     counts, lengths, cfg_, write=write)
            finally:
                undo()
            dense = _dense_from_pools(torch, pools, page_idx, counts)
            unembed = T.common.unembed

            def keep(tbl, x, **kw):
                hidden.append(x)
                return unembed(tbl, x, **kw)
            undo = _route_spy(torch, PM, dense_routes, force=eng_routes)
            T.common.unembed = keep
            try:
                want, _ = T.decode_step(params_, dense, tok, pos, cfg_,
                                        write=write)
            finally:
                undo()
                T.common.unembed = unembed
            _check_dbrx_step(torch, params_, logits, want, hidden[0], write,
                             eng_routes, dense_routes, stats)
            return logits, pools
        T.decode_step_paged = decode
        try:
            LS.serve(eng, reqs)
        finally:
            T.decode_step_paged = orig
        return eng, reqs, stats

    eng, reqs, wall, launches = run(False)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    n_steps = eng.steps_run
    fed = sum(len(r.prompt) - 1 + len(r.generated) for r in reqs)
    gen = sum(len(r.generated) for r in reqs)
    log(f"dbrx serve: {len(reqs)} requests (prompts "
        f"{min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {SERVE_NEW} new each), "
        f"max_batch {eng.max_batch}, page_size {eng.page_size}: {n_steps} "
        f"steps ({fed} tokens fed, {gen} generated) in {wall:.2f} s = "
        f"{gen / wall:.2f} generated tokens/s, {fed / wall:.1f} fed "
        f"tokens/s, {1e3 * wall / n_steps:.2f} ms per step; "
        f"max_memory_allocated {peak:.2f} GB; launches {launches} "
        f"({card_line() if cuda else device})")
    want = n_layers * n_steps
    if launches["paged_decode"] != want:
        raise AssertionError(f"paged_decode launched {launches['paged_decode']}"
                             f" times, not {n_layers} layers x {n_steps} "
                             "steps")
    _all_pages_back(eng)
    tokens = [r.generated for r in reqs]
    if cuda:
        serve_profile(torch, SV, LS, obs, cfg, params, eng, seed)
    t = time.perf_counter()
    eng2, reqs2, st = run(True)
    if [r.generated for r in reqs2] != tokens:
        raise AssertionError("dbrx: the checked run gave other tokens than "
                             "the timed run")
    _all_pages_back(eng2)
    log(f"dbrx check against decode_step routed as the engine: all "
        f"{st['steps']} steps' logits compared; {st['exact']} with a top-2 "
        f"gap of at least {GAP_TOL} equal decode_step's argmax; "
        f"{len(st['logit_ties'])} logit near-ties within tolerance (step, "
        f"gap, behind, tolerance): {st['logit_ties']}; "
        f"{len(st['router_ties'])} steps with a router near-tie, where the "
        f"replay's own top {cfg.top_k} differs from the engine's (step, "
        f"(layer, row, k-th / (k+1)-th gap)): {st['router_ties']}; largest "
        f"such gap {st['tie_gap']:.4g} (at most {ROUTER_TIE}); router "
        f"probabilities within {st['noise']:.4g} (at most {ROUTER_DRIFT}); "
        f"max |engine top logit - decode_step logit for that token| at "
        f"most {st['ratio']:.3f} of its tolerance; all pages back in the "
        f"pool; {time.perf_counter() - t:.1f} s")
    launch = None
    if cuda:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
        (err, share, ms, old, pms, lib, bound, n_live), kv_len, splits = \
            largest_launch(torch, SK, SR, cfg, eng2, st["largest"][1], 0,
                           gen, flush)
        del flush
        launch = {"launches": launches["paged_decode"], "ms": ms,
                  "plain_ms": pms, "bound_ms": bound[0],
                  "bound_by": bound[1], "library_ms": lib,
                  "max_abs_err": err, "lengths": kv_len.tolist()}
        log(f"paged_decode at dbrx-132b's largest serving launch (B "
            f"{eng2.max_batch}, KVH {cfg.n_kv_heads}, G "
            f"{cfg.n_heads // cfg.n_kv_heads}, D {cfg.hd}, page "
            f"{eng2.page_size}, lengths {kv_len.tolist()}, {n_live} live "
            f"positions, bf16, {splits}; cold L2): {ms:.4f} ms card-opened "
            f"(host-opened timer {old:.4f} ms; plain {pms:.3f} ms, bound "
            f"{bound[0]:.4f} ms by {bound[1]}, {100 * bound[0] / ms:.1f} % "
            f"of it; scaled_dot_product_attention {lib:.4f} ms with the "
            f"gather excluded); max abs err {err:.3g}, {share:.3g} of its "
            f"tolerance; launches "
            f"{launches['paged_decode']} in the timed run ({card_line()})")
    del params, eng, eng2
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"steps": n_steps, "ms_per_step": 1e3 * wall / n_steps,
            "launches": launches["paged_decode"], "peak_gb": peak,
            "serve_launch": launch}


def _all_pages_back(eng):
    if eng.table.seq_pages or len(eng.table.free) != eng.table.n_pages:
        raise AssertionError(f"{eng.cfg.name}: pages leaked, not every page "
                             "is back in the pool")


def _check_dbrx_step(torch, params, got, want, x, write, eng_routes,
                     dense_routes, st):
    """One engine step against the dense-cache step (``dbrx_path``)."""
    st["steps"] += 1
    step = st["steps"]
    b = int(torch.nonzero(write)[0, 0])
    # layer by layer (the replay routed as the engine): the router
    # probabilities agree within ROUTER_DRIFT (the two paths round
    # attention at other places); where the replay's own top k differs
    # from the engine's, the row is a router near-tie
    if len(eng_routes) != len(dense_routes):
        raise AssertionError(f"dbrx step {step}: {len(eng_routes)} routed "
                             f"layers against {len(dense_routes)}")
    diff = []
    for layer, (e, d) in enumerate(zip(eng_routes, dense_routes)):
        noise = float((e[3] - d[3]).abs().max())
        st["noise"] = max(st["noise"], noise)
        if noise > ROUTER_DRIFT:
            raise AssertionError(
                f"dbrx step {step}: layer {layer}'s router probabilities "
                f"differ by {noise:.4g} (more than {ROUTER_DRIFT})")
        if torch.equal(e[0], d[0]):
            if not torch.equal(e[1], d[1]):
                raise AssertionError(f"dbrx step {step}: layer {layer} "
                                     "chooses alike but keeps other pairs")
            continue
        for r in torch.nonzero((e[0] != d[0]).any(-1)).flatten().tolist():
            gap = float(torch.minimum(e[2][r], d[2][r]))
            st["tie_gap"] = max(st["tie_gap"], gap)
            if gap >= ROUTER_TIE:
                raise AssertionError(
                    f"dbrx step {step}: layer {layer}'s replay would route "
                    f"row {r} differently with a router gap of {gap:.4g} "
                    f"(at least {ROUTER_TIE})")
            diff.append((layer, r, round(gap, 6)))
    if diff:
        st["router_ties"].append((step, diff))
    table = params["embed"]["table"]
    e_row, d_row = got[b, 0].float(), want[b, 0].float()
    tok = int(torch.argmax(e_row))
    top2 = torch.topk(d_row, 2)
    arg = int(top2.indices[0])
    gap = float(top2.values[0] - top2.values[1])
    xa = x[b, 0].float().abs()
    tol_tok, tol_top = (LOGIT_ULP * float((xa * table[v].float().abs()).sum())
                        for v in (tok, arg))
    off = abs(float(e_row[tok]) - float(d_row[tok]))
    st["ratio"] = max(st["ratio"], off / tol_tok)
    if off > tol_tok:
        raise AssertionError(f"dbrx step {step}: engine top logit "
                             f"{float(e_row[tok]):.6g}, decode_step's logit "
                             f"for it {float(d_row[tok]):.6g}, beyond "
                             f"{tol_tok:.4g}")
    if gap >= GAP_TOL:
        if tok != arg:
            raise AssertionError(f"dbrx step {step}: engine token {tok}, "
                                 f"decode_step's argmax {arg} (gap "
                                 f"{gap:.4g})")
        st["exact"] += 1
        return
    behind = float(top2.values[0]) - float(d_row[tok])
    if behind > tol_top + tol_tok:
        raise AssertionError(f"dbrx step {step}: a near-tie (gap {gap:.4g}) "
                             f"where decode_step's logit for the engine's "
                             f"token is {behind:.4g} below its top, beyond "
                             f"{tol_top + tol_tok:.4g}")
    st["logit_ties"].append((step, round(gap, 5), round(behind, 5),
                             round(tol_top + tol_tok, 5)))


def stream_path(torch, T, cfg, params, prompts, memory=None,
                device="cuda"):
    """Stream ``prompts`` (one row each) through ``init_decode_caches`` /
    ``decode_step``: prompt tokens, then ``STREAM_NEW`` greedy tokens a
    row; then hold every step of every row to teacher-forced ``forward``
    over the row's prompt and its own tokens with the serving phase's rule
    (its top-2 gap, tol(v) from forward's final hidden state). Returns ms
    per step over the steps after the first (the first call of a new
    model also loads its kernels), which is logged apart."""
    B = len(prompts)
    lens = [len(p) for p in prompts]
    n = max(lens) + STREAM_NEW - 1
    seqs = [list(map(int, p)) for p in prompts]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    caches = T.init_decode_caches(cfg, B, n, device=device)
    tops = []
    sync()
    t0 = time.perf_counter()
    for t in range(n):
        tok = torch.tensor([[s[t] if t < len(s) else 0] for s in seqs],
                           device=device)
        pos = torch.full((B,), t, dtype=torch.int32, device=device)
        logits, caches = T.decode_step(params, caches, tok, pos, cfg,
                                       memory=memory)
        top = torch.max(logits[:, 0].float(), dim=-1)
        tops.append(top)
        nxt = top.indices.tolist()
        for b in range(B):
            if lens[b] - 1 <= t and len(seqs[b]) < lens[b] + STREAM_NEW:
                seqs[b].append(nxt[b])
        if t == 0:
            t1 = time.perf_counter()
    sync()
    first, wall = t1 - t0, time.perf_counter() - t1
    top_val = torch.stack([t.values for t in tops], 1).cpu().numpy()
    top_tok = torch.stack([t.indices for t in tops], 1).cpu().numpy()
    # forward over each row's prompt and its own tokens but the last
    fed = [s[:-1] for s in seqs]
    tokens = np.zeros((B, max(map(len, fed))), np.int64)
    for b, s in enumerate(fed):
        tokens[b, :len(s)] = s
    table = (params["embed"] if cfg.tie_embeddings
             else params["unembed"])["table"]
    hidden = []
    unembed = T.common.unembed

    def keep(tbl, x, **kw):
        hidden.append(x)
        return unembed(tbl, x, **kw)
    T.common.unembed = keep
    try:
        f_all, _ = T.forward(params, torch.from_numpy(tokens).to(device),
                             cfg, memory=memory)
    finally:
        T.common.unembed = unembed
    x_all = hidden.pop()
    exact = total = 0
    near, ratio = [], 0.0
    for b in range(B):
        m = len(fed[b])
        f = f_all[b, :m].float()
        top2 = torch.topk(f, 2)
        gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        arg = top2.indices[:, 0]
        tok = torch.as_tensor(top_tok[b, :m], device=device)
        at_tok = f.gather(1, tok[:, None])[:, 0]
        xa = x_all[b, :m].float().abs()
        tol_tok, tol_top = (LOGIT_ULP * (xa * table[v].float().abs()).sum(
            1).cpu().numpy() for v in (tok, arg))
        behind = (top2.values[:, 0] - at_tok).cpu().numpy()
        at_tok, arg = at_tok.cpu().numpy(), arg.cpu().numpy()
        off = np.abs(top_val[b, :m] - at_tok)
        ratio = max(ratio, float((off / tol_tok).max()))
        for k in range(m):
            total += 1
            if off[k] > tol_tok[k]:
                raise AssertionError(
                    f"{cfg.name} row {b} step {k}: decode_step's top logit "
                    f"{top_val[b, k]:.6g}, forward's logit for its token "
                    f"{at_tok[k]:.6g}, beyond {tol_tok[k]:.4g}")
            if gap[k] >= GAP_TOL:
                if top_tok[b, k] != arg[k]:
                    raise AssertionError(
                        f"{cfg.name} row {b} step {k}: decode_step's token "
                        f"{top_tok[b, k]}, forward's argmax {arg[k]} (gap "
                        f"{gap[k]:.4g})")
                exact += 1
            elif behind[k] > tol_top[k] + tol_tok[k]:
                raise AssertionError(
                    f"{cfg.name} row {b} step {k}: a near-tie (gap "
                    f"{gap[k]:.4g}) where forward's logit for decode_step's "
                    f"token is {behind[k]:.4g} below its top, beyond "
                    f"{tol_top[k] + tol_tok[k]:.4g}")
            else:
                near.append((b, k, round(float(gap[k]), 5)))
    log(f"{cfg.name} stream: {B} prompts ({min(lens)}-{max(lens)} tokens), "
        f"{STREAM_NEW} new each, {n} decode_step calls: the first "
        f"{1e3 * first:.1f} ms, the other {n - 1} in {wall:.2f} s = "
        f"{1e3 * wall / (n - 1):.2f} ms per step "
        f"({B * STREAM_NEW / (first + wall):.1f} generated tokens/s over "
        f"all); against forward: all {total} row-steps "
        f"compared, {exact} with a top-2 gap of at least {GAP_TOL} equal "
        f"its argmax, {len(near)} near-ties within tolerance (row, step, "
        f"gap): {near}; max |decode_step top logit - forward logit for that "
        f"token| at most {ratio:.3f} of its tolerance "
        f"({card_line() if device == 'cuda' else device})")
    return 1e3 * wall / (n - 1)


def decode_profile(torch, T, cfg, params, memory, n=8):
    """``n`` warm ``decode_step`` calls of the stream's batch under
    ``torch.profiler``: device busy time against the window's wall time and
    the work that takes it (the profiler adds host time, so the idle share
    is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    B = 4 if memory is None else memory.shape[0]
    caches = T.init_decode_caches(cfg, B, n + 1)
    tok = torch.ones((B, 1), dtype=torch.long, device="cuda")

    def step(t):
        pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
        return T.decode_step(params, caches, tok, pos, cfg, memory=memory)
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, n + 1):
            logits, _ = step(t)
            logits.argmax(-1).tolist()          # the stream's host sync
        wall_ms = 1e3 * (time.perf_counter() - t0)
    log(f"profile {cfg.name} decode_step: {n} steps of batch {B}, wall "
        f"{wall_ms:.1f} ms ({wall_ms / n:.2f} ms per step); "
        f"{device_summary(prof, wall_ms)} ({card_line()})")


def state_paths(torch, T, seed, device="cuda", cfgs=None):
    """rwkv6-1.6b and whisper-base at full width and depth: 4 prompts each
    streamed through ``decode_step`` (whisper with ``encode``'s memory over
    ``specs.ENC_FRAMES`` stub frames), held to ``forward``. ``device`` /
    ``cfgs`` rehearse it on the CPU at reduced configs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import ENC_FRAMES
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    for cfg in cfgs or [get_config(a) for a in ("rwkv6-1.6b",
                                                 "whisper-base")]:
        arch = cfg.name
        t0 = time.perf_counter()
        params = T.init_lm(cfg, seed, device=device)
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(1, cfg.vocab, n) for n in (4, 7, 9, 11)]
        memory = None
        if cfg.layer_pattern == "encdec":
            gen = torch.Generator(device=device).manual_seed(seed)
            frames = torch.randn((len(prompts), ENC_FRAMES, cfg.d_model),
                                 generator=gen, device=device)
            sync()
            t = time.perf_counter()
            memory = T.encode(params, frames, cfg)
            sync()
            log(f"{arch} encode: {ENC_FRAMES} stub frames x "
                f"{len(prompts)} in {1e3 * (time.perf_counter() - t):.1f} "
                f"ms, memory {tuple(memory.shape)} {memory.dtype}")
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"{arch}: full width and depth, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
            f"{cfg.param_dtype} parameters, compute {cfg.compute_dtype}")
        out[arch] = stream_path(torch, T, cfg, params, prompts, memory,
                                device)
        if cuda:
            decode_profile(torch, T, cfg, params, memory)
        log(f"{arch} phase: {time.perf_counter() - t0:.1f} s")
        del params, memory
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def registry_path(torch, T, SK, tree_map, seed):
    """The reduced configs of jamba, qwen2-vl (``specs.VIS_TOKENS`` stub
    patch embeddings), llama4, starcoder2 and stablelm-3b in f32 compute on the
    card against the same calls on the CPU from the same parameters:
    ``forward``, ``lm_loss``, two ``decode_step`` calls and, on
    attention-only patterns, one ``decode_step_paged`` through the paged
    decode kernel (one launch a layer), within ``REG_ATOL`` / ``REG_RTOL``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import VIS_TOKENS

    def close(what, got, want):
        g, w = got.float().cpu().numpy(), want.float().numpy()
        err = float(np.abs(g - w).max())
        if not np.allclose(g, w, atol=REG_ATOL, rtol=REG_RTOL):
            raise AssertionError(f"{what}: card and CPU differ by up to "
                                 f"{err:.3g}")
        return err

    rng = np.random.default_rng(seed)
    SK.reset_launch_counts()
    want_launches, worst = 0, 0.0
    for arch in REGISTRY_ARCHS:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="float32")
        cpu = T.init_lm(cfg, seed, device="cpu")
        card = tree_map(lambda t: t.to("cuda"), cpu)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
        extra = None
        if cfg.frontend == "vision":
            extra = torch.from_numpy(rng.standard_normal(
                (2, VIS_TOKENS, cfg.d_model)).astype(np.float32))
        res = {}
        for dev, p in (("cpu", cpu), ("cuda", card)):
            ex = None if extra is None else extra.to(dev)
            tk = tokens.to(dev)
            logits, aux = T.forward(p, tk, cfg, extra_embeds=ex)
            loss = T.lm_loss(p, tk, tk.roll(-1, 1), cfg, extra_embeds=ex)
            caches = T.init_decode_caches(cfg, 2, 8, device=dev)
            steps = []
            for s in range(2):
                pos = torch.tensor([1 + s, 5 + s], device=dev)
                lg, caches = T.decode_step(p, caches, tk[:, s:s + 1], pos,
                                           cfg)
                steps.append(lg)
            res[dev] = [logits, aux, loss, *steps]
            if all(k.startswith("attn") for k in cfg.block_kinds()):
                res[dev].append(_paged_step(torch, T, cfg, p, dev, seed))
        names = ["forward", "aux", "lm_loss", "decode_step 0",
                 "decode_step 1", "decode_step_paged"]
        for name, got, want in zip(names, res["cuda"], res["cpu"]):
            worst = max(worst, close(f"{arch} {name}", got, want))
        if len(res["cuda"]) == len(names):
            want_launches += cfg.n_layers
        del cpu, card
    launches = SK.launch_counts["paged_decode"]
    log(f"registry (reduced, f32 compute, card vs CPU): "
        f"{', '.join(REGISTRY_ARCHS)}: forward (qwen2-vl with "
        f"{VIS_TOKENS} stub patches), lm_loss, two decode_step calls and "
        f"one decode_step_paged on the attention-only ones agree to "
        f"{worst:.3g} (tolerance {REG_ATOL} + {REG_RTOL} x |value|); "
        f"paged_decode launches {launches} (one a layer: {want_launches})")
    if launches != want_launches:
        raise AssertionError("decode_step_paged did not launch paged_decode "
                             "once a layer")
    return launches


def _paged_step(torch, T, cfg, params, dev, seed, page=4):
    """One ``decode_step_paged`` over random pools (seeded, the same on
    every device), each row writing into a page of its own."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([6, 13], np.int32)
    counts = (pos // page + 1).astype(np.int32)
    P = int(counts.sum()) + 3
    perm = rng.permutation(P)
    page_idx = np.zeros((2, 8), np.int32)
    page_idx[0, :counts[0]] = perm[:counts[0]]
    page_idx[1, :counts[1]] = perm[counts[0]:counts.sum()]
    pools = [{k: torch.from_numpy(rng.standard_normal(
        (cfg.n_superblocks, P, page, cfg.n_kv_heads, cfg.hd)).astype(
            np.float32)).to(dev) for k in ("k", "v")}
        for _ in cfg.block_kinds()]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1))).to(dev)

    def t(a):
        return torch.from_numpy(a).to(dev)
    logits, _ = T.decode_step_paged(params, pools, tok, t(pos), t(page_idx),
                                    t(counts), t(pos), cfg)
    return logits


# =============================================================================
# training: gemma2-2b with Roaring block-sparse attention
# =============================================================================

def check_sparse_flash(torch, cases, SK, SR, seed):
    """The block-sparse flash kernel against its plain version over
    ``cases.FLASH_GRID`` (G 1 / 2, D 64 / 128 / 256, softcap on and off,
    causal and not) and ``cases.FLASH_REGISTRY_GRID`` (the registry's
    training pairs: G 5 / 6 / 8 / 12 at D = 128, G 1 at D = 80), in bf16
    and f32, at the model's block of 128: a row
    that lists only a block in its future (zeros when causal), a row with
    ``counts = 0``, padding ids after ``counts``, and NaN in the one block
    no row lists."""
    rng = np.random.default_rng(seed)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    grid = cases.FLASH_GRID + cases.FLASH_REGISTRY_GRID
    for G, D, softcap, causal in grid:
        c = cases.sparse_flash_case(rng, G, D)
        t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
        for dtype in worst:
            q, k, v = (t[n].to(dtype) for n in "qkv")
            opts = dict(causal=causal, softcap=softcap)
            got = SK.sparse_flash_attention_cuda(q, k, v, t["kv_idx"],
                                                 t["counts"], **opts)
            want = SR.sparse_attention_ref(q, k, v, t["kv_idx"],
                                           t["counts"], **opts)
            torch.cuda.synchronize()
            empty = got[:, :, cases.FLASH_BLOCK:2 * cases.FLASH_BLOCK]
            future = got[:, :, :cases.FLASH_BLOCK]
            if (got.dtype != dtype or not bool(torch.isfinite(got).all())
                    or bool(empty.any()) or (causal and bool(future.any()))):
                raise AssertionError(
                    f"sparse_flash_attention G={G} D={D} softcap={softcap} "
                    f"causal={causal} {dtype}: non-finite output or a "
                    "non-zero row without live scores")
            err = (got.float() - want.float()).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
    log(f"check sparse_flash_attention: {len(grid)} cases (the registry's "
        f"(G, D) {[c[:2] for c in cases.FLASH_REGISTRY_GRID]} among them) x "
        f"(bf16, f32); max abs err {worst[torch.bfloat16]:.3g} (bf16, "
        f"tolerance {BF16_ATOL}), {worst[torch.float32]:.3g} (f32, "
        f"tolerance {F32_ATOL}); rows without live scores zero, the NaN "
        "block never read")
    if worst[torch.bfloat16] > BF16_ATOL or worst[torch.float32] > F32_ATOL:
        raise AssertionError("sparse_flash_attention disagrees with its "
                             "plain version")


def _plain_sparse_attention(SR):
    """``attention``'s sparse entry, but through the plain version on the
    card (the kernel's comparison run)."""
    def plain(q, k, v, kv_idx, counts, block_q, block_kv, causal, softcap,
              scale):
        return SR.sparse_attention_ref(q, k, v, kv_idx, counts,
                                       block_q=block_q, block_kv=block_kv,
                                       causal=causal, softcap=softcap,
                                       scale=scale)
    return plain


def train_path(torch, T, SK, SR, TR, cfg, seed, device="cuda"):
    """gemma2-2b at full width and depth, random weights, Roaring
    block-sparse global layers: ``TRAIN_STEPS`` AdamW steps (remat full) on
    one batch from the data pipeline. Checks 2 kernel launches per global
    layer per step, step 0 against the same step through the plain version,
    finite metrics and a falling loss; then profiles two more steps.
    Returns (launches, params, block lists, batch)."""
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.optim import OptimizerDef, adamw, cosine_schedule
    from repro_torch.sparsity import build_arch_mask, compile_mask

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed, device=device)
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    pipe = LT.build_data(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_QUERY, seed)
    toks, mask, _ = pipe.next_batch()
    batch = {"tokens": torch.from_numpy(toks).to(device),
             "mask": torch.from_numpy(mask).to(device)}
    n_blocks = TRAIN_SEQ // cfg.sparse_block
    lists = compile_mask(build_arch_mask(n_blocks, **TRAIN_MASK))
    live = int(lists[1].sum())
    log(f"train model: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, attn_impl {cfg.attn_impl}; "
        f"{n_params / 1e9:.3f} B parameters ({cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}); batch {TRAIN_BATCH} (CUT from train_4k's "
        f"256) x {TRAIN_SEQ} tokens from query {TRAIN_QUERY!r} "
        f"({pipe.selection.size} docs, {int(mask.sum())} loss positions); "
        f"block lists {TRAIN_MASK}: {live} of {n_blocks ** 2} blocks live, "
        f"max_active {lists[0].shape[1]}; init {time.perf_counter() - t0:.1f}"
        " s")
    if live != TRAIN_LIVE_BLOCKS:
        raise AssertionError(f"{live} live blocks, expected "
                             f"{TRAIN_LIVE_BLOCKS}")

    # step 0 with the global layers through the plain version on the card;
    # no optimizer state (step 0's learning rate is 0 under the warm-up)
    probe = TR.make_train_step(cfg, _noop_optimizer(OptimizerDef),
                               remat="full", block_lists=lists)
    orig = A.sparse_attention
    A.sparse_attention = _plain_sparse_attention(SR)
    try:
        t = time.perf_counter()
        _, m = probe(TR.TrainState(params, None, 0), batch)
        plain = (float(m["loss"]), float(m["grad_norm"]))
        t_plain = time.perf_counter() - t
    finally:
        A.sparse_attention = orig
    gc.collect()

    opt = adamw(cosine_schedule(3e-4, warmup=20, total=TRAIN_STEPS))
    state = TR.TrainState(params, opt.init(params), 0)
    step = TR.make_train_step(cfg, opt, remat="full", block_lists=lists)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    SK.reset_launch_counts()
    metrics, times, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = SK.launch_counts["sparse_flash_attention"]
        t = time.perf_counter()
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        sync()
        times.append(time.perf_counter() - t)
        per_step.append(SK.launch_counts["sparse_flash_attention"] - before)
    launches = dict(SK.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    card = card_line() if cuda else device
    ms = 1e3 * float(np.mean(times[1:]))
    log("train steps (loss, grad norm): " + "; ".join(
        f"{a:.5f}, {b:.4f}" for a, b in metrics))
    log(f"train: {TRAIN_STEPS} steps, step 0 {1e3 * times[0]:.1f} ms, steps "
        f"1-{TRAIN_STEPS - 1} {ms:.1f} ms per step = "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.1f} tokens/s; "
        f"max_memory_allocated {peak:.2f} GB; the plain version's step 0 "
        f"(no optimizer) {1e3 * t_plain:.1f} ms ({card})")
    loss0, gn0 = metrics[0]
    log(f"step 0 through the kernel vs the plain version on the card: loss "
        f"{loss0:.6f} vs {plain[0]:.6f} (rel "
        f"{abs(loss0 - plain[0]) / abs(plain[0]):.3g}, tolerance "
        f"{LOSS_RTOL}), grad norm {gn0:.5f} vs {plain[1]:.5f} (rel "
        f"{abs(gn0 - plain[1]) / abs(plain[1]):.3g}, tolerance {GNORM_RTOL})")
    if not np.all(np.isfinite(metrics)):
        raise AssertionError("a loss or grad norm is not finite")
    if (abs(loss0 - plain[0]) > LOSS_RTOL * abs(plain[0])
            or abs(gn0 - plain[1]) > GNORM_RTOL * abs(plain[1])):
        raise AssertionError("step 0 through the kernel disagrees with the "
                             "plain version")
    if not metrics[-1][0] < metrics[0][0]:
        raise AssertionError("the loss did not fall")
    want = 2 * cfg.n_superblocks
    log(f"launches on the train path: {launches}; per step {per_step} "
        f"({cfg.n_superblocks} global layers x 2: the forward and its "
        "recompute under remat)")
    if per_step != [want] * TRAIN_STEPS:
        raise AssertionError("sparse_flash_attention was not launched twice "
                             "per global layer per step")
    train_profile(torch, step, state, batch, device)
    del state, step
    gc.collect()
    return launches, params, lists, batch, ms


def train_profile(torch, step, state, batch, device="cuda", n=2,
                  label="train"):
    """Two more steps under ``torch.profiler``: their wall time, device busy
    time against it and the top device work. The profiler adds host time,
    so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as p:
        t = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, batch)
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    log(f"profile {label}: {n} steps, wall {wall_ms:.1f} ms ("
        f"{wall_ms / n:.1f} ms per step); {device_summary(p, wall_ms, 8)}; "
        f"{gemm_summary(p)} ({card_line() if cuda else device})")


# substrings of the names of cuBLAS's and CUTLASS's matrix-product kernels
GEMM_NAMES = ("gemm", "xmma", "nvjet", "cutlass")


def gemm_summary(prof) -> str:
    """Launches and device time of the matrix-product kernels of a profiled
    window (kernels whose name holds one of ``GEMM_NAMES``)."""
    from torch.autograd import DeviceType
    n, ms = 0, 0.0
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and any(g in e.key.lower() for g in GEMM_NAMES)):
            n += e.count
            ms += e.self_device_time_total / 1e3
    return f"matrix-product kernels: {n} launches, {ms:.2f} ms"


def sparse_flash_bound(q, k, kv_idx, counts, block, causal=True):
    """(bound_ms, bound_by, live pairs) of one launch: q, k, v and out each
    moved once, plus the block lists; QK and PV at 2 operations per
    multiply-add over each live (query, key) pair, over the bf16
    tensor-core peak."""
    B, H, S, D = q.shape
    KVH, S_kv = k.shape[1], k.shape[2]
    item = q.element_size()
    rows = np.arange(block)
    pairs = 0
    for qb in range(kv_idx.shape[0]):
        r = qb * block + rows
        for kb in kv_idx[qb, :counts[qb]]:
            c0 = int(kb) * block
            per_row = (np.clip(r - c0 + 1, 0, block) if causal
                       else np.full(block, block))
            pairs += int(per_row.sum())
    nbytes = (2 * B * H * S * D + 2 * B * KVH * S_kv * D) * item \
        + 4 * (kv_idx.size + counts.size)
    ops = pairs * B * H * 4 * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            pairs)


def sparse_flash_row(torch, T, SK, SR, cfg, params, lists, batch, launches,
                     regs, path="the train path"):
    """The kernel on the inputs the full-width path gave its first global
    layer (captured in an untimed forward), L2 overwritten before each
    launch, beside its plain version and ``scaled_dot_product_attention``
    with the block lists expanded to a boolean mask (no softcap: it cannot
    apply one); with the tensor-core kernel's registers (``regs``)."""
    import torch.nn.functional as Fn
    captured = []
    orig = SK.sparse_flash_attention_cuda

    def capture(*args, **kw):
        if not captured:
            captured.append((tuple(a.clone() for a in args), dict(kw)))
        return orig(*args, **kw)

    SK.sparse_flash_attention_cuda = capture
    try:
        with torch.no_grad():
            T.forward(params, batch["tokens"][:, :-1], cfg,
                      block_lists=tuple(torch.from_numpy(a).cuda()
                                        for a in lists),
                      extra_embeds=batch.get("extra_embeds"))
    finally:
        SK.sparse_flash_attention_cuda = orig
    (q, k, v, kv_idx, counts), kw = captured[0]
    got = SK.sparse_flash_attention_cuda(q, k, v, kv_idx, counts, **kw)
    want = SR.sparse_attention_ref(q, k, v, kv_idx, counts, **kw)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # both round an f32 result to bf16: at most one bf16 ulp apart, and an
    # ulp is at most 2**-7 of the larger magnitude (the trained model's
    # outputs pass 2, where BF16_ATOL, one ulp below 2, no longer covers it)
    ulp = 2.0 ** -7 * torch.maximum(got.float().abs(), want.float().abs())
    if bool((diff > ulp + F32_ATOL).any()):
        raise AssertionError(f"sparse_flash_attention disagrees with its "
                             f"plain version by more than one bf16 rounding "
                             f"(max abs err {err:.4g})")
    log(f"sparse_flash_attention at {path}'s input: max abs err "
        f"{err:.4g}, within one bf16 rounding of the output everywhere "
        f"(|out| up to {want.float().abs().max().item():.3g})")
    del got, want, diff, ulp
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    call = lambda: SK.sparse_flash_attention_cuda(  # noqa: E731
        q, k, v, kv_idx, counts, **kw)
    ms = time_cold_ms(torch, call, 20, flush)
    old = enqueue_time_cold_ms(torch, call, 20, flush)
    pms = enqueue_time_cold_ms(torch, lambda: SR.sparse_attention_ref(
        q, k, v, kv_idx, counts, **kw), 5, flush)
    B, H, S, D = q.shape
    dense = SR.block_mask_to_dense(kv_idx, counts, S // kw["block_kv"])
    mask = dense.repeat_interleave(kw["block_q"], 0).repeat_interleave(
        kw["block_kv"], 1) & torch.ones(S, S, dtype=torch.bool,
                                        device="cuda").tril()
    lib = time_cold_ms(torch, lambda: Fn.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), 20, flush)
    bound, pairs = sparse_flash_bound(q, k, kv_idx.cpu().numpy(),
                                      counts.cpu().numpy(), kw["block_q"],
                                      kw["causal"])
    heads = 2 if (H // k.shape[1]) % 2 == 0 else 1
    log(f"sparse_flash_attention tensor-core kernel (D = {D}, {heads} heads "
        f"a block): "
        f"{kernel_regs(regs, f'sparse_flash_mma_kernelILi{D}ELi{heads}E')}")
    return _row("sparse_flash_attention", launches, err, ms, pms, bound,
                f"{path}'s first global layer: B = {B}, H = {H}, KVH = "
                f"{k.shape[1]}, S = {S}, D = {D}, {q.dtype}, softcap "
                f"{kw['softcap']}, {int(counts.sum())} listed blocks, "
                f"{pairs} live pairs; cold L2",
                (lib, "scaled_dot_product_attention (block lists expanded "
                 "to a boolean mask, no softcap)"), old_ms=old)


def launcher_path(torch, LT, simulate_failure):
    """``launch/train.py``'s ``main`` on the card at the reduced config,
    under ``ResilientTrainer`` with one simulated failure: one restart
    exactly, and the final parameters equal an uninterrupted run's."""
    t = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as d:
            whole = LT.main(LAUNCH_ARGS + ["--ckpt", f"{d}/whole"])
            failed = LT.main(LAUNCH_ARGS + ["--ckpt", f"{d}/failed"],
                             failure_source=simulate_failure(LAUNCH_FAIL_AT))
    finally:
        torch.use_deterministic_algorithms(False)
    pw, pf = (_leaves(r["state"]["params"]) for r in (whole, failed))
    same = all(torch.equal(a, b) for a, b in zip(pw, pf))
    log(f"launcher: reduced {LAUNCH_ARGS[1]}, 6 steps, checkpoints every 2; "
        f"a failure injected at step(s) {sorted(LAUNCH_FAIL_AT)}: restarts "
        f"{failed['restarts']} (uninterrupted run {whole['restarts']}), "
        f"losses {whole['losses'][0]:.4f} -> {whole['losses'][-1]:.4f}; "
        f"final parameters {'equal' if same else 'DIFFER'}; "
        f"{time.perf_counter() - t:.1f} s")
    if whole["restarts"] != 0 or failed["restarts"] != len(LAUNCH_FAIL_AT):
        raise AssertionError("restarts differ from the injected failures")
    if not same:
        raise AssertionError("the restored run ended on other parameters")



# =============================================================================
# training the rest of the registry: qwen2-vl-72b at full width, then every
# reduced config on the card against the CPU
# =============================================================================

def check_adafactor_state(params, state):
    """Every leaf's Adafactor state has the reference's shapes: row and
    column statistics (``vr`` [..., n], ``vc`` [..., m]) where the trailing
    [n, m] tile has both dims at least 8 and at least 4,096 values, a full
    ``v`` elsewhere. Returns (factored leaves, all leaves, state floats)."""
    from repro_torch._tree import leaf_nodes
    n_fact, n_all, floats = 0, 0, 0
    for p, s in zip(_leaves(params), leaf_nodes(params, state)):
        shp = tuple(p.shape)
        fact = (len(shp) >= 2 and shp[-1] >= 8 and shp[-2] >= 8
                and shp[-1] * shp[-2] >= 4096)
        want = ({"vr": shp[:-1], "vc": shp[:-2] + shp[-1:]} if fact
                else {"v": shp})
        got = {k: tuple(v.shape) for k, v in s.items()}
        if got != want:
            raise AssertionError(f"Adafactor state of a {shp} leaf is {got}, "
                                 f"expected {want}")
        n_fact += fact
        n_all += 1
        floats += sum(v.numel() for v in s.values())
    return n_fact, n_all, floats


def _noop_optimizer(OptimizerDef):
    return OptimizerDef(lambda p: None, lambda g, s, p, t: s)


def qwen_train_path(torch, T, SK, SR, TR, seed, regs=None, device="cuda",
                    cfg=None, seq=QWEN_SEQ, live_blocks=QWEN_LIVE_BLOCKS):
    """qwen2-vl-72b at full width, cut to ``QWEN_LAYERS`` layers, bf16 as
    published, every layer through the block-sparse kernel: ``QWEN_STEPS``
    steps of ``pick_optimizer``'s optimizer (Adafactor) at a constant
    ``QWEN_LR``, remat "full", on one batch of ``VIS_TOKENS`` stub patches
    and ``seq - VIS_TOKENS`` tokens from the data pipeline. Checks step 0
    against the plain version, a falling loss, 2 launches a layer a step
    and the Adafactor state's shapes; then one step under remat "dots" on
    the same state, held to a "full" pass over it, ``QWEN_AB`` warmed steps
    of "full" and "dots" in turn, timed, and a profile of "dots"; on the
    card, the
    kernel's row at this path's first layer (``sparse_flash_row``).
    ``device`` / ``cfg`` / ``seq`` / ``live_blocks`` rehearse it on the CPU
    at a reduced config. Returns (launches, the kernel's row or None)."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.models import flops as FL
    from repro_torch.sparsity import build_arch_mask, compile_mask

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    card = card_line() if cuda else device
    full = get_config(QWEN_ARCH)
    cfg = cfg or dataclasses.replace(full, n_layers=QWEN_LAYERS,
                                     attn_impl="sparse")
    t0 = time.perf_counter()
    params = T.init_lm(cfg, seed, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    n_tok = seq - specs.VIS_TOKENS
    pipe = LT.build_data(cfg, 1, n_tok, TRAIN_QUERY, seed)
    toks, mask, _ = pipe.next_batch()
    gen = torch.Generator(device=device).manual_seed(seed)
    extra = torch.randn((1, specs.VIS_TOKENS, cfg.d_model), generator=gen,
                        device=device).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(toks).to(device),
             "mask": torch.from_numpy(mask).to(device),
             "extra_embeds": extra}
    n_blocks = seq // cfg.sparse_block
    lists = compile_mask(build_arch_mask(n_blocks, **QWEN_MASK))
    live = int(lists[1].sum())
    sync()
    log(f"qwen train model: {cfg.name}, CUT to {cfg.n_layers} of "
        f"{full.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, M-RoPE {cfg.mrope_sections}, attn_impl "
        f"{cfg.attn_impl}; {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}, compute {cfg.compute_dtype}); batch 1 x {seq} "
        f"positions (CUT from train_4k's 256 x 4,096): {specs.VIS_TOKENS} "
        f"stub patches ({extra.dtype}) then {n_tok} tokens from query "
        f"{TRAIN_QUERY!r} ({int(mask.sum())} loss positions); block lists "
        f"{QWEN_MASK}: {live} of {n_blocks ** 2} blocks live, max_active "
        f"{lists[0].shape[1]}; init {time.perf_counter() - t0:.1f} s")
    if live != live_blocks:
        raise AssertionError(f"{live} live blocks, expected {live_blocks}")

    # step 0 with every layer through the plain version on the card
    probe = TR.make_train_step(cfg, _noop_optimizer(optim.OptimizerDef),
                               remat="full", block_lists=lists)
    orig = A.sparse_attention
    A.sparse_attention = _plain_sparse_attention(SR)
    try:
        t = time.perf_counter()
        _, m = probe(TR.TrainState(params, None, 0), batch)
        plain = (float(m["loss"]), float(m["grad_norm"]))
        t_plain = time.perf_counter() - t
    finally:
        A.sparse_attention = orig
    gc.collect()

    name = specs.pick_optimizer(full).name
    opt = getattr(optim, name)(QWEN_LR)
    state = TR.TrainState(params, opt.init(params), 0)
    n_fact, n_all, floats = check_adafactor_state(params, state["opt"]) \
        if name == "adafactor" else (0, 0, 0)
    step = TR.make_train_step(cfg, opt, remat="full", block_lists=lists)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    SK.reset_launch_counts()
    metrics, times, per_step = [], [], []
    for _ in range(QWEN_STEPS):
        before = SK.launch_counts["sparse_flash_attention"]
        t = time.perf_counter()
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        sync()
        times.append(time.perf_counter() - t)
        per_step.append(SK.launch_counts["sparse_flash_attention"] - before)
    launches = dict(SK.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    if name == "adafactor":
        check_adafactor_state(params, state["opt"])
    ms = 1e3 * float(np.mean(times[1:]))
    flops = FL.cell_flops(cfg, kind="train", seq_len=seq,
                          global_batch=1).total
    log("qwen train steps (loss, grad norm): " + "; ".join(
        f"{a:.5f}, {b:.4f}" for a, b in metrics))
    log(f"qwen train: pick_optimizer({full.name}) = {name} (constant lr "
        f"{QWEN_LR}; its state: {n_fact} of {n_all} leaves factored, "
        f"{floats / 1e6:.2f} M floats for {n_params / 1e9:.3f} B parameters)"
        f", remat full; {QWEN_STEPS} steps, step 0 {1e3 * times[0]:.1f} ms, "
        f"steps 1-{QWEN_STEPS - 1} {ms:.1f} ms per step = "
        f"{seq / ms * 1e3:.1f} positions/s; max_memory_allocated "
        f"{peak:.2f} GB; analytic {flops:.4e} FLOPs a step "
        f"(models/flops.py) = {flops / ms / 1e9:.2f} TFLOP/s "
        f"({flops / ms / 1e9 / BF16_TFLOPS:.2%} of {BF16_TFLOPS:.0f}); the "
        f"plain version's step 0 (no optimizer) {1e3 * t_plain:.1f} ms "
        f"({card})")
    loss0, gn0 = metrics[0]
    log(f"qwen step 0 through the kernel vs the plain version: loss "
        f"{loss0:.6f} vs {plain[0]:.6f} (rel "
        f"{abs(loss0 - plain[0]) / abs(plain[0]):.3g}, tolerance "
        f"{LOSS_RTOL}), grad norm {gn0:.5f} vs {plain[1]:.5f} (rel "
        f"{abs(gn0 - plain[1]) / abs(plain[1]):.3g}, tolerance {GNORM_RTOL})")
    if not np.all(np.isfinite(metrics)):
        raise AssertionError("a qwen loss or grad norm is not finite")
    if (abs(loss0 - plain[0]) > LOSS_RTOL * abs(plain[0])
            or abs(gn0 - plain[1]) > GNORM_RTOL * abs(plain[1])):
        raise AssertionError("qwen step 0 through the kernel disagrees with "
                             "the plain version")
    if not metrics[-1][0] < metrics[0][0]:
        raise AssertionError("the qwen loss did not fall")
    want = 2 * cfg.n_superblocks
    log(f"launches on the qwen train path: {launches}; per step {per_step} "
        f"({cfg.n_superblocks} global layers x 2: the forward and its "
        "recompute under remat)")
    if per_step != [want] * QWEN_STEPS:
        raise AssertionError("sparse_flash_attention was not launched twice "
                             "per layer per qwen step")
    train_profile(torch, step, state, batch, device, label="qwen train")

    # remat "dots" on the same state: a "full" pass without an update, then
    # one "dots" step (with the update)
    t = time.perf_counter()
    _, m = probe(TR.TrainState(params, None, 0), batch)
    ref = (float(m["loss"]), float(m["grad_norm"]))
    t_full = time.perf_counter() - t
    gc.collect()
    dots = TR.make_train_step(cfg, opt, remat="dots", block_lists=lists)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = SK.launch_counts["sparse_flash_attention"]
    t = time.perf_counter()
    state, m = dots(state, batch)
    got = (float(m["loss"]), float(m["grad_norm"]))
    sync()
    t_dots = time.perf_counter() - t
    dots_launches = SK.launch_counts["sparse_flash_attention"] - before
    dots_peak = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                 else float("nan"))
    log(f"qwen remat dots: loss {got[0]:.6f} vs full {ref[0]:.6f} (rel "
        f"{abs(got[0] - ref[0]) / abs(ref[0]):.3g}), grad norm {got[1]:.5f} "
        f"vs {ref[1]:.5f} (rel {abs(got[1] - ref[1]) / abs(ref[1]):.3g}); "
        f"dots step {1e3 * t_dots:.1f} ms, max_memory_allocated "
        f"{dots_peak:.2f} GB; the full pass (no optimizer) "
        f"{1e3 * t_full:.1f} ms; launches {dots_launches} ({card})")
    if (abs(got[0] - ref[0]) > LOSS_RTOL * abs(ref[0])
            or abs(got[1] - ref[1]) > GNORM_RTOL * abs(ref[1])):
        raise AssertionError("remat dots disagrees with remat full")
    if dots_launches != want:
        raise AssertionError("remat dots did not launch the kernel twice a "
                             "layer")
    ab = {"full": [], "dots": []}
    for _ in range(QWEN_AB):
        for remat, fn in (("full", step), ("dots", dots)):
            t = time.perf_counter()
            state, m = fn(state, batch)
            float(m["loss"])
            sync()
            ab[remat].append(1e3 * (time.perf_counter() - t))
    log(f"qwen remat full vs dots, {QWEN_AB} warmed steps each in turn: "
        + "; ".join(f"{k} " + ", ".join(f"{x:.1f}" for x in v) + " ms"
                    for k, v in ab.items())
        + f" (means {np.mean(ab['full']):.1f} / {np.mean(ab['dots']):.1f} "
        f"ms; {card})")
    train_profile(torch, dots, state, batch, device,
                  label="qwen train remat dots")
    del step, dots, probe
    gc.collect()
    row = (sparse_flash_row(torch, T, SK, SR, cfg, params, lists, batch,
                            launches, regs, path="the qwen train path")
           if cuda else None)
    del state, params, batch
    gc.collect()
    return launches, row


def _reduced_train_cfg(arch, FLASH_HEAD_DIMS):
    """A reduced config in f32 compute, block-sparse wherever it has
    attention at a head dim the kernel is built for."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    if (any(k.startswith("attn") for k in cfg.block_kinds())
            and cfg.hd in FLASH_HEAD_DIMS):
        cfg = dataclasses.replace(cfg, attn_impl="sparse")
    return cfg


def registry_train_path(torch, T, SK, TR, tree_map, seed, device="cuda",
                        archs=None):
    """Every reduced config of the registry: ``REG_TRAIN_STEPS`` train
    steps on the card and on the CPU from the same state (f32 compute),
    losses, grad norms and final parameters within ``REG_ATOL`` /
    ``REG_RTOL``. The optimizer is ``pick_optimizer``'s for the full config
    (``REG_ADAMW8BIT`` takes 8-bit AdamW), at a constant ``REG_LR``; remat
    "full", "dots" on ``REG_DOTS``; qwen2-vl with ``VIS_TOKENS`` stub
    patches, whisper with ``ENC_FRAMES`` frames of memory and without it.
    On the card the block-sparse layers launch the kernel twice a step.
    Returns the launches."""
    from repro_torch import optim
    from repro_torch.configs import get_config, list_archs
    from repro_torch.kernels.sparse_attn.kernel import FLASH_HEAD_DIMS
    from repro_torch.launch import specs
    from repro_torch.sparsity import build_arch_mask, compile_mask

    rng = np.random.default_rng(seed)
    runs = [(a, False) for a in archs or list_archs()]
    runs += [(a, True) for a, _ in runs if a == "whisper-base"]
    SK.reset_launch_counts()
    want_launches, worst, lines = 0, 0.0, []
    t0 = time.perf_counter()
    for arch, memory in runs:
        cfg = _reduced_train_cfg(arch, FLASH_HEAD_DIMS)
        sparse = cfg.attn_impl == "sparse"
        lists = (compile_mask(build_arch_mask(
            REG_SEQ // cfg.sparse_block, pattern="local_global",
            window_blocks=1, n_global=1)) if sparse else None)
        n_extra = specs.VIS_TOKENS if cfg.frontend == "vision" else 0
        batches = []
        for _ in range(REG_TRAIN_STEPS):
            b = {"tokens": rng.integers(1, cfg.vocab, (2, REG_SEQ - n_extra
                                                       + 1)),
                 "mask": (rng.random((2, REG_SEQ - n_extra + 1))
                          < 0.9).astype(np.float32)}
            if n_extra:
                b["extra_embeds"] = rng.standard_normal(
                    (2, n_extra, cfg.d_model)).astype(np.float32)
            if memory:
                b["memory"] = rng.standard_normal(
                    (2, specs.ENC_FRAMES, cfg.d_model)).astype(np.float32)
            batches.append({k: torch.from_numpy(v) for k, v in b.items()})
        name = ("adamw8bit" if arch == REG_ADAMW8BIT
                else specs.pick_optimizer(get_config(arch)).name)
        remat = "dots" if arch == REG_DOTS else "full"
        cpu = T.init_lm(cfg, seed, device="cpu")
        res = {}
        for dev in ("cpu", device):
            p = tree_map(lambda t: t.detach().to(dev, copy=True), cpu)
            opt = getattr(optim, name)(REG_LR)
            state = TR.TrainState(p, opt.init(p), 0)
            step = TR.make_train_step(cfg, opt, remat=remat,
                                      block_lists=lists)
            out = []
            for b in batches:
                state, m = step(state, {k: v.to(dev) for k, v in b.items()})
                out += [m["loss"].detach().cpu(),
                        m["grad_norm"].detach().cpu()]
            res[dev] = out + [t.detach().cpu() for t in _leaves(
                state["params"])]
        for got, want in zip(res[device], res["cpu"]):
            g, w = got.float().numpy(), want.float().numpy()
            err = float(np.abs(g - w).max())
            worst = max(worst, err)
            if not np.allclose(g, w, atol=REG_ATOL, rtol=REG_RTOL):
                raise AssertionError(
                    f"{arch} (memory={memory}) training: card and CPU "
                    f"differ by up to {err:.3g}")
        n_global = sum(k.startswith("attn") and "local" not in k
                       for k in cfg.block_kinds())
        if sparse:
            want_launches += 2 * REG_TRAIN_STEPS * cfg.n_superblocks * n_global
        lines.append(f"{arch}{' + memory' if memory else ''} ({name}, "
                     f"remat {remat}, attn {cfg.attn_impl}) losses "
                     + " / ".join(f"{float(x):.4f}"
                                  for x in res[device][0:2 * REG_TRAIN_STEPS:2]))
    launches = SK.launch_counts["sparse_flash_attention"]
    log(f"registry train (reduced, f32 compute, card vs CPU, "
        f"{REG_TRAIN_STEPS} steps, lr {REG_LR}, batch 2 x {REG_SEQ} "
        f"positions): " + "; ".join(lines) + f". Losses, grad norms and "
        f"every parameter agree to {worst:.3g} (tolerance {REG_ATOL} + "
        f"{REG_RTOL} x |value|); sparse_flash_attention launches {launches} "
        f"(2 a block-sparse layer a step: {want_launches}); "
        f"{time.perf_counter() - t0:.1f} s")
    if device == "cuda" and launches != want_launches:
        raise AssertionError("the reduced registry's training did not launch "
                             "sparse_flash_attention twice a layer a step")
    return launches


# =============================================================================
# the paper's rows: Roaring against WAH, Concise and BitSet
# =============================================================================

def _median_ms(fn, sync, n=PAPER_REPEATS):
    """Median wall time of ``n`` calls, each ended by ``sync`` (one warm
    call first); returns (ms, the last call's result)."""
    out = fn()
    sync()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), out


def _paper_formats(B, slab, values):
    """One value set in the four formats: the card slab, the host Roaring
    bitmap (the port's ``py_roaring``), WAH, Concise and BitSet."""
    host = slab.to_roaring()
    if not np.array_equal(host.to_array(), values):
        raise AssertionError("a slab does not hold its value set")
    return {"card": slab, "host": host,
            "wah": B.WahBitmap.from_sorted_unique(values),
            "concise": B.ConciseBitmap.from_sorted_unique(values),
            "bitset": B.BitSet.from_sorted_unique(values)}


def _paper_sizes(name, f, n):
    """Bytes and bits per value of each format for one set; returns the
    row and logs it."""
    row = {"set": name, "card": n,
           "roaring": len(f["card"].serialize()),
           "wah": f["wah"].size_in_bytes(),
           "concise": f["concise"].size_in_bytes(),
           "bitset": f["bitset"].size_in_bytes()}
    bits = {k: 8 * row[k] / max(n, 1)
            for k in ("roaring", "wah", "concise", "bitset")}
    log(f"paper size {name}: {n} values; bytes (bits per value) Roaring "
        f"{row['roaring']} ({bits['roaring']:.2f}), WAH {row['wah']} "
        f"({bits['wah']:.2f}), Concise {row['concise']} "
        f"({bits['concise']:.2f}), BitSet {row['bitset']} "
        f"({bits['bitset']:.2f}); WAH / Roaring "
        f"{row['wah'] / row['roaring']:.3f}, Concise / Roaring "
        f"{row['concise'] / row['roaring']:.3f}")
    return row


def _paper_ops(torch, name, fa, fb, sync):
    """AND and OR of one pair in each format, timed (median of
    ``PAPER_REPEATS``); every format's result must give the same values,
    and ``and_card`` the AND's count. Returns the row and logs it."""
    row = {"pair": name}
    for op in ("and", "or"):
        ms, got = {}, {}
        card_op = (lambda: fa["card"] & fb["card"]) if op == "and" else (
            lambda: fa["card"] | fb["card"])
        ms["card"], out = _median_ms(card_op, sync)
        got["card"] = out.to_roaring().to_array()
        host = (lambda: fa["host"] & fb["host"]) if op == "and" else (
            lambda: fa["host"] | fb["host"])
        ms["host"], out = _median_ms(host, lambda: None)
        got["host"] = out.to_array()
        for fmt in ("wah", "concise"):
            fn = getattr(fa[fmt], op + "_")
            ms[fmt], out = _median_ms(lambda: fn(fb[fmt]), lambda: None)
            got[fmt] = out.to_array()
        if op == "and":
            ms["card_and_card"], n = _median_ms(
                lambda: fa["card"].and_card(fb["card"]), sync)
            if int(n) != got["card"].size:
                raise AssertionError(f"paper {name}: and_card {int(n)} != "
                                     f"{got['card'].size}")
        want = got["host"]
        for fmt, vals in got.items():
            if not np.array_equal(np.asarray(vals, np.int64),
                                  np.asarray(want, np.int64)):
                raise AssertionError(f"paper {name} {op}: {fmt} differs "
                                     "from the host Roaring result")
        row[op] = ms
        row[op + "_card"] = int(want.size)
        log(f"paper {op.upper()} {name}: {want.size} values, all four "
            f"formats equal; ms card {ms['card']:.4f}"
            + (f" (and_card {ms['card_and_card']:.4f})" if op == "and"
               else "")
            + f", host Roaring {ms['host']:.4f}, WAH {ms['wah']:.4f}, "
            f"Concise {ms['concise']:.4f}; WAH / card "
            f"{ms['wah'] / ms['card']:.2f}x, Concise / card "
            f"{ms['concise'] / ms['card']:.2f}x, WAH / host Roaring "
            f"{ms['wah'] / ms['host']:.2f}x, Concise / host Roaring "
            f"{ms['concise'] / ms['host']:.2f}x")
    return row


def paper_rows(torch, K, B, index, postings, terms, device="cuda"):
    """The paper's comparison on the search index: the terms at Zipf ranks
    1, 2, 4, ..., 2,048 sweep the density; each term's size in the four
    formats, and AND / OR of each adjacent pair, Roaring on the card
    (object API, wall time synced) and on the host against WAH and Concise
    on the host (the ``expanded`` engine), every result equal. Returns
    (rows, launches); fails if ``intersect_dispatch`` never launched."""
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    ranks = [r for r in PAPER_RANKS if r <= len(terms)]
    sets = {}
    for r in ranks:
        t = terms[r - 1]
        sets[r] = (_paper_formats(B, index.posting(t), postings[t]),
                   postings[t].size)
    t_build = time.perf_counter() - t0
    sizes = [_paper_sizes(f"rank {r}", *sets[r]) for r in ranks]
    K.reset_launch_counts()
    ops = [_paper_ops(torch, f"ranks {a} x {b}", sets[a][0], sets[b][0],
                      sync) for a, b in zip(ranks, ranks[1:])]
    launches = dict(K.launch_counts)
    log(f"launches on the paper path: {launches}")
    if cuda and launches["intersect_dispatch"] <= 0:
        raise AssertionError("intersect_dispatch never launched on the "
                             "paper path")
    log(f"paper rows: {len(sizes)} terms, {len(ops)} pairs; formats built "
        f"in {t_build:.1f} s ({card_line() if cuda else device})")
    return {"sizes": sizes, "ops": ops}, launches


def paper_db_pair(torch, K, B, RS, store, device="cuda"):
    """The paper's database pair at the store's scale: ``lo_year = 1993``
    and ``lo_discount = 1`` (Q1.1's operands), sizes and AND / OR in the
    four formats as ``paper_rows``."""
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    fs = []
    for col, v in PAPER_DB_PAIR:
        c = store.column(col)
        rb = store.slot_bitmap(c.base_slot + c.values.index(v))
        vals = rb.to_array()
        slab = RS.RoaringSlab.from_roaring(rb, store.n_chunks, device=device)
        fs.append((_paper_formats(B, slab, vals), vals.size))
    t_build = time.perf_counter() - t0
    names = [f"{c} = {v}" for c, v in PAPER_DB_PAIR]
    sizes = [_paper_sizes(n, *f) for n, f in zip(names, fs)]
    K.reset_launch_counts()
    ops = _paper_ops(torch, " x ".join(names), fs[0][0], fs[1][0], sync)
    if cuda and K.launch_counts["intersect_dispatch"] <= 0:
        raise AssertionError("intersect_dispatch never launched on the "
                             "paper's database pair")
    log(f"paper database pair over {store.n_rows} rows: formats built in "
        f"{t_build:.1f} s; {time.perf_counter() - t0:.1f} s in all "
        f"({card_line() if cuda else device})")
    return {"sizes": sizes, "ops": [ops]}


# =============================================================================
# one-rank process groups: sharded search, compressed training
# =============================================================================

def one_rank_group(torch, device="cuda"):
    """Join a one-rank process group (NCCL on the card, gloo on the CPU)
    through a file store; no network. Returns the store's path."""
    import torch.distributed as dist
    fd, path = tempfile.mkstemp(prefix="smoke-pg-")
    os.close(fd)
    os.remove(path)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{path}", rank=0,
                            world_size=1)
    return path


def leave_group(path):
    import torch.distributed as dist
    dist.destroy_process_group()
    if os.path.exists(path):
        os.remove(path)


def sharded_search(torch, S, K, ops, index, terms, seed, device="cuda"):
    """``PostingIndex.shard`` over a one-rank ``("data",)`` mesh: the
    smoke's 96 top-k queries (``main_path``'s stream) scored by the local
    index inside the service, and each query slab again by the sharded
    index; scores and rows must be identical. Counts the stacked kernel's
    launches through the ``LaunchEvent`` hook."""
    from torch.distributed.device_mesh import DeviceMesh
    cuda = device == "cuda"
    path = one_rank_group(torch, device)
    t0 = time.perf_counter()
    try:
        mesh = DeviceMesh("cuda" if cuda else "cpu", torch.arange(1),
                          mesh_dim_names=("data",))
        sharded = index.shard(mesh)
        seen = []
        local_topk = index.topk

        def recording(query, k):
            out = local_topk(query, k)
            seen.append((query, k, out))
            return out

        events = {"local": 0, "sharded": 0}
        phase = ["local"]

        def hook(ev):
            if ev.entry == "intersect_dispatch_stacked":
                events[phase[0]] += 1

        qs = make_queries(S, terms, 96, seed + 2)
        svc = S.SearchService(index, max_batch=16, cache_slots=256,
                              fused=True)
        K.reset_launch_counts()
        ops.add_launch_hook(hook)
        index.topk = recording
        try:
            svc.search_many(qs, "topk", k=10)
            phase[0] = "sharded"
            got = [sharded.topk(q, k) for q, k, _ in seen]
        finally:
            del index.topk
            ops.remove_launch_hook(hook)
        launches = dict(K.launch_counts)
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for (_, _, a), b in zip(seen, got))
        log(f"sharded search: {sharded!r} over mesh "
            f"{mesh.mesh_dim_names} of {mesh.size()} rank; {len(seen)} top-k "
            f"queries, sharded == local scores and rows: {same}; "
            f"stacked_card_kernel launches (LaunchEvent hook) local "
            f"{events['local']}, sharded {events['sharded']}; "
            f"{time.perf_counter() - t0:.1f} s")
        if len(seen) != len(qs) or not same:
            raise AssertionError("sharded top-k differs from local top-k")
        if events["sharded"] != len(seen) or (
                cuda and launches["intersect_dispatch_stacked"]
                != events["local"] + events["sharded"]):
            raise AssertionError("the sharded top-k did not run one stacked "
                                 "launch per query")
    finally:
        leave_group(path)
    return launches


def _check_compressed_leaf(torch, g, out, k):
    """One leaf of the compressed mean on one rank against its definition,
    in plain torch: the nonzeros number min(k, nonzeros of g); each equals
    g there; no dropped magnitude exceeds the smallest kept one; among
    equal magnitudes at that threshold the kept ones have the lower
    indices. Returns whether the leaf had a tie across the threshold."""
    g, o = g.reshape(-1), out.reshape(-1)
    kept = o != 0
    nnz, nz_g = int(kept.sum()), int(torch.count_nonzero(g))
    if nnz != min(k, nz_g):
        raise AssertionError(f"{nnz} values kept, want min({k}, {nz_g})")
    if not torch.equal(o[kept], g[kept]):
        raise AssertionError("a kept value differs from the gradient")
    if nnz < k:
        return False
    mag = g.abs()
    t = mag[kept].min()
    if float(torch.where(kept, 0.0, mag).max()) > float(t):
        raise AssertionError("a dropped magnitude exceeds a kept one")
    tie = mag == t
    dropped = torch.nonzero(tie & ~kept).flatten()
    if dropped.numel() and int(dropped.min()) < int(
            torch.nonzero(tie & kept).max()):
        raise AssertionError("a tie at the threshold kept a higher index")
    return bool(dropped.numel())


def compressed_train_path(torch, TR, K, SK, cfg, params, lists, batch,
                          plain_ms, device="cuda", profile=False):
    """gemma2-2b steps with the Roaring top-k cross-pod gradient mean
    (``grad_compression={"axis": "pod", "ratio": 0.01}``) under a one-rank
    ``("pod",)`` mesh. Step 0 checks every leaf against the definition
    (``_check_compressed_leaf``) and takes the tree's compression ratio;
    the later steps keep nothing but a reference to the embedding leaf's
    ``CompressedLeaf``, and give the ms a step and the peak memory.
    After the last step, the embedding leaf's support at step 2 is scored
    against steps 0 and 1 with ``leaf_overlap_many`` (one stacked launch)
    and ``leaf_overlap`` / ``leaf_jaccard`` (the dispatch kernel) against
    ``np.intersect1d``. With ``profile``, two more steps run under the
    profiler. Returns (launches, ms per step, ratio, peak GB)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch import grad_comp as GC
    from repro_torch.distributed import context
    from repro_torch.grad_comp import topk_roaring as TK
    from repro_torch.optim import adamw, cosine_schedule

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    comp = {"axis": "pod", "ratio": COMP_RATIO}
    embed = params["embed"]["table"]
    n_embed = embed.numel()
    sent, embeds, ties, checked = [], [], [], []
    metrics, times = [], []
    orig_mean, orig_compress = GC.compressed_crosspod_mean, TK.compress_leaf

    def compress(g, k):
        c = orig_compress(g, k)
        if g.numel() == n_embed:
            embeds.append(c)
        if not times:
            sent.append((g.numel(), GC.compression_ratio(c, g.numel())))
        return c

    def mean(grads, **kw):
        if checked:
            return orig_mean(grads, **kw)
        for g in _leaves(grads):
            before = g.clone()
            orig_mean([g], **kw)
            k = max(64, int(np.ceil(g.numel() * kw["ratio"])))
            ties.append(_check_compressed_leaf(torch, before, g, k))
            checked.append(g.numel())
            del before
        return grads

    path = one_rank_group(torch, device)
    opt = adamw(cosine_schedule(3e-4, warmup=20, total=COMP_STEPS))
    state = TR.TrainState(params, opt.init(params), 0)
    step = TR.make_train_step(cfg, opt, remat="full", block_lists=lists,
                              grad_compression=comp)
    try:
        mesh = DeviceMesh("cuda" if cuda else "cpu", torch.arange(1),
                          mesh_dim_names=("pod",))
        sync()
        K.reset_launch_counts()
        SK.reset_launch_counts()
        GC.compressed_crosspod_mean, TK.compress_leaf = mean, compress
        try:
            with context.data_axes(("pod",), 1, None, mesh=mesh):
                for i in range(COMP_STEPS):
                    if i == 1 and cuda:
                        torch.cuda.reset_peak_memory_stats()
                    t = time.perf_counter()
                    state, m = step(state, batch)
                    sync()
                    times.append(time.perf_counter() - t)
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
        finally:
            GC.compressed_crosspod_mean, TK.compress_leaf = (orig_mean,
                                                             orig_compress)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else \
            float("nan")
        ratio = sum(n * r for n, r in sent) / sum(n for n, _ in sent)
        kept = sum(x.numel() * x.element_size() for c in embeds[:2]
                   for x in (c.slab.keys, c.slab.kinds, c.slab.cards,
                             c.slab.nruns, c.slab.payload, c.values))
        supports = [torch.nonzero(GC.decompress_leaf(
            c, embed.shape, embed.dtype).reshape(-1)).flatten().cpu().numpy()
            for c in embeds]
        c0, c1, c2 = embeds[:3]
        many = GC.leaf_overlap_many(c2, [c0, c1]).cpu().numpy()
        pair = int(GC.leaf_overlap(c2, c1))
        jac = float(GC.leaf_jaccard(c2, c1))
        sync()
        launches = {**K.launch_counts, **SK.launch_counts}
        if profile:
            with context.data_axes(("pod",), 1, None, mesh=mesh):
                train_profile(torch, step, state, batch, device,
                              label="compressed train")
    finally:
        leave_group(path)
    want = [np.intersect1d(supports[2], supports[s]).size for s in (0, 1)]
    union = np.union1d(supports[2], supports[1]).size
    k_embed = max(64, int(np.ceil(n_embed * COMP_RATIO)))
    card = card_line() if cuda else device
    ms = 1e3 * float(np.mean(times[1:]))
    log(f"compressed train steps (loss, grad norm): " + "; ".join(
        f"{a:.5f}, {b:.4f}" for a, b in metrics))
    log(f"compressed train: {COMP_STEPS} steps, grad_compression {comp} "
        f"over a one-rank ('pod',) mesh; step 0 (leaf checks) "
        f"{1e3 * times[0]:.1f} ms, steps 1-{COMP_STEPS - 1} (no checks) "
        f"{ms:.1f} ms per step against {plain_ms:.1f} without compression; "
        f"compression ratio of the whole tree at step 0 {ratio:.5f} "
        f"(Roaring index bits + f32 values over dense f32 bits); "
        f"max_memory_allocated over steps 1-{COMP_STEPS - 1} {peak:.2f} GB, "
        f"{kept / 1e9:.3f} GB of it the embedding leaves kept for the "
        f"overlap check ({card})")
    log(f"compressed step 0: {len(checked)} leaves ({sum(checked)} "
        f"elements) hold their top-k exactly: each kept value equals the "
        f"gradient, no dropped magnitude exceeds a kept one, ties at the "
        f"threshold keep the lower index ({sum(ties)} leaves had such a "
        f"tie)")
    log(f"support overlap of the embedding leaf (k = {k_embed} of "
        f"{n_embed}): step 2 against steps 0-1 leaf_overlap_many "
        f"{many.tolist()}, np.intersect1d {want}; leaf_overlap (step 2 x 1) "
        f"{pair}, leaf_jaccard {jac:.6f} (np {want[1] / union:.6f}); "
        f"launches {launches}")
    if len(checked) != len(_leaves(params)) or \
            len(sent) != len(checked):
        raise AssertionError("step 0 did not check every leaf")
    if not np.all(np.isfinite(metrics)):
        raise AssertionError("a compressed step's loss or grad norm is not "
                             "finite")
    if many.tolist() != want or pair != want[1] or \
            abs(jac - want[1] / union) > 1e-6:
        raise AssertionError("support overlaps differ from np.intersect1d")
    if len(embeds) != COMP_STEPS or any(s.size != k_embed
                                        for s in supports):
        raise AssertionError("the embedding leaf did not keep k values")
    per_step = 2 * cfg.n_superblocks * COMP_STEPS
    if cuda and (launches["sparse_flash_attention"] != per_step
                 or launches["intersect_dispatch_stacked"] <= 0
                 or launches["intersect_dispatch"] <= 0):
        raise AssertionError("a kernel of the compressed train path was not "
                             "launched")
    del state, step
    gc.collect()
    return launches, ms, ratio, peak


def flop_rates(cfg, train_ms, comp_ms, serve_rates, device="cuda"):
    """Analytic FLOP rates (``models/flops.py``) of the training and
    serving runs, and their share of the card's bf16 dense peak."""
    from repro_torch.models import flops as FL
    card = card_line() if device == "cuda" else device
    train = FL.cell_flops(cfg, kind="train", seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH).total
    ref = FL.model_flops_reference(cfg, kind="train", seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH)
    parts = []
    for name, ms in (("plain", train_ms), ("compressed", comp_ms)):
        parts.append(
            f"{name} {ms:.1f} ms a step: analytic {train / ms / 1e9:.2f} "
            f"TFLOP/s ({train / ms / 1e9 / BF16_TFLOPS:.2%} of "
            f"{BF16_TFLOPS:.0f} TFLOP/s bf16 dense), 6 N D "
            f"{ref / ms / 1e9:.2f} TFLOP/s ({ref / ms / 1e9 / BF16_TFLOPS:.2%})")
    log(f"FLOP rate, training ({cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ}): "
        f"cell_flops {train:.4e} FLOPs a step, model_flops_reference "
        f"{ref:.4e}; " + "; ".join(parts) + ". The analytic model counts "
        "dense attention, where the 13 global layers compute "
        f"{TRAIN_LIVE_BLOCKS} of {(TRAIN_SEQ // cfg.sparse_block) ** 2} "
        "blocks, and one forward where remat='full' runs two "
        f"({card})")
    from repro_torch.configs import get_config
    scfg = get_config(SERVE_ARCH)
    total = sum(FL.cell_flops(scfg, kind="decode", seq_len=s,
                              global_batch=1).total
                for n in serve_rates["fed"] for s in range(1, n + 1))
    steps, wall = serve_rates["steps"], serve_rates["wall_s"]
    ms = 1e3 * wall / steps
    log(f"FLOP rate, serving ({scfg.name}): cell_flops(kind='decode') over "
        f"each of {steps} steps' context, {total / steps:.4e} FLOPs a step "
        f"on average, over {ms:.2f} ms a step = {total / wall / 1e12:.4f} "
        f"TFLOP/s ({total / wall / 1e12 / BF16_TFLOPS:.4%} of "
        f"{BF16_TFLOPS:.0f}) ({card})")


def dryrun_phase(DR):
    """``launch.dryrun`` over every architecture, shape and mesh, on the
    host (``meta`` tensors; the card is not touched), into a temporary
    directory; its per-cell lines go to a log there. One line: the cells
    that are ok, and for ``DRY_ARCHS`` each cell's per-rank GB of
    arguments and the dominant roofline term."""
    import contextlib
    with tempfile.TemporaryDirectory() as out:
        with open(os.path.join(out, "dryrun.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            recs = DR.main(["--archs", "all", "--shapes", "all", "--meshes",
                            "single,multi", "--out", out,
                            "--no-skip-existing"])
    bad = [f"{r['cell']}: {r.get('error')}" for r in recs if not r["ok"]]
    summary = {a: {f"{r['shape']} {r['chips']}": [
        round(r["arg_bytes"]["total"] / 1e9, 4),
        r["roofline"]["dominant"]] for r in recs if r["arch"] == a}
        for a in DRY_ARCHS}
    log(f"dry run: {len(recs) - len(bad)}/{len(recs)} cells ok (per-rank "
        "GB of arguments, dominant roofline term, the collectives a model "
        "of the placements; H100 figures; JSON): "
        + json.dumps(summary))
    if bad or len(recs) != DRY_CELLS:
        raise AssertionError(f"dry run: {len(recs)} cells, failed: {bad}")


def _masked_columns_f32(torch, T, cfg, S, seed, device):
    """LONG_STEPS decode steps of one super-block of ``cfg`` in f32 compute
    (its widths; caches f32) through an ``S``-position cache and a
    ``LONG_SHORT_CACHE``-position one: the largest logit difference over
    the largest logit. Raises beyond LONG_F32_RTOL."""
    c32 = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=cfg.superblock)
    params = T.init_lm(c32, seed, device=device)
    long, small = (T.init_decode_caches(c32, 1, n, device=device)
                   for n in (S, LONG_SHORT_CACHE))
    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(1, c32.vocab, (LONG_STEPS, 1, 1), generator=gen,
                         device=device, dtype=torch.int32)
    err = 0.0
    with torch.no_grad():
        for i in range(LONG_STEPS):
            pos = torch.full((1,), i, dtype=torch.int32, device=device)
            got, _ = T.decode_step(params, long, toks[i], pos, c32)
            ref, _ = T.decode_step(params, small, toks[i], pos, c32)
            got, ref = got[..., :c32.vocab], ref[..., :c32.vocab]
            err = max(err, ((got - ref).abs().max()
                            / ref.abs().max()).item())
    del params, long, small, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    if not err <= LONG_F32_RTOL:
        raise AssertionError(f"long_500k: in f32, masked columns changed "
                             f"the logits by {err:.3g} of the largest")
    return err


def long_cell_path(torch, T, A, SP, DR, SK, SR, tree, seed, device="cuda"):
    """``build_cell(LONG_ARCH, LONG_SHAPE, LONG_MESH)`` realized on the card
    (parameters from the seed, zero caches, then ``serve_step``): every
    leaf with the built shape and dtype, positions 0..LONG_STEPS-1 against
    a ``LONG_SHORT_CACHE``-position cache, LONG_STEPS timed steps at the
    last positions of a seeded cache, and at the last step one global
    layer's dense attention against ``paged_decode`` over the same rows as
    pages (``_long_paged_row``)."""
    fn, args, specs, _, meta = SP.build_cell(LONG_ARCH, LONG_SHAPE,
                                             LONG_MESH)
    want = DR.arg_bytes(meta["kind"], args, specs, LONG_MESH)
    from repro_torch.configs import get_config
    cfg = get_config(LONG_ARCH)
    S = meta["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    f32_err = _masked_columns_f32(torch, T, cfg, S, seed, device)
    base = torch.cuda.memory_allocated()
    log(f"long_500k: {base / 1e9:.3f} GB allocated before realizing")
    t = time.perf_counter()
    params = T.init_lm(cfg, seed, device=device)
    caches = [{k: torch.zeros(v.shape, dtype=v.dtype, device=device)
               for k, v in c.items()} for c in args[1]]
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
             for k, v in args[2].items()}
    torch.cuda.synchronize()
    real = (params, caches, batch)
    for (path, a), b in zip(tree.leaves_with_paths(args), tree.leaves(real)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"long_500k: {path} realized as "
                                 f"{tuple(b.shape)} {b.dtype}, built as "
                                 f"{tuple(a.shape)} {a.dtype}")
    log(f"long_500k realized in {time.perf_counter() - t:.1f} s: "
        f"{len(tree.leaves(real))} tensors, each with the built shape and "
        f"dtype, {torch.cuda.memory_allocated() - base} bytes allocated; "
        f"the dry run's per-rank argument bytes {want['total']} (params "
        f"{want['params']}, caches {want['caches']}, batch {want['batch']})")

    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(1, cfg.vocab, (LONG_STEPS, 1, 1), generator=gen,
                         device=device, dtype=torch.int32)
    table = (params["embed"] if cfg.tie_embeddings
             else params["unembed"])["table"].abs()
    hidden = []
    unembed = T.common.unembed

    def keep(tbl, x, **kw):             # each step's final hidden state
        hidden.append(x)
        return unembed(tbl, x, **kw)
    small = T.init_decode_caches(cfg, 1, LONG_SHORT_CACHE, device=device)
    worst = ratio = 0.0
    T.common.unembed = keep
    try:
        with torch.no_grad():
            for i in range(LONG_STEPS):
                batch["tokens"].copy_(toks[i])
                batch["pos"].fill_(i)
                got, _ = fn(params, caches, batch)
                ref, _ = T.decode_step(params, small, batch["tokens"],
                                       batch["pos"], cfg)
                x = hidden[-1].float().abs().reshape(1, -1)
                tol = LOGIT_ULP * (x @ table.T)[0, :cfg.vocab]
                off = (got - ref)[0, 0, :cfg.vocab].abs()
                worst = max(worst, off.max().item())
                ratio = max(ratio, (off / tol).max().item())
                hidden.clear()
    finally:
        T.common.unembed = unembed
    del small, got, ref, table, x, tol, off
    log(f"long_500k positions 0-{LONG_STEPS - 1} against a "
        f"{LONG_SHORT_CACHE}-position cache: max |logit difference| "
        f"{worst:.4g}, {ratio:.3g} of the serving rule's tolerance (one bf16 "
        f"ulp in each element of the final hidden state); f32 compute, "
        f"one super-block: within {f32_err:.3g} of the largest logit "
        f"(tolerance {LONG_F32_RTOL})")
    if not ratio <= 1.0:
        raise AssertionError("long_500k: masked columns changed the logits")

    seeded = S - LONG_STEPS
    t = time.perf_counter()
    for c in caches:
        for k in ("k", "v"):
            c[k][:, :, :seeded].normal_(generator=gen)
    torch.cuda.synchronize()
    log(f"long_500k: K / V of positions below {seeded} drawn from the seed "
        f"in {time.perf_counter() - t:.1f} s")
    seen = []
    orig = A.decode_attention

    def spy(q, ck, cv, pos, cfg, *, layer_kind="attn_mlp", write=None):
        out = orig(q, ck, cv, pos, cfg, layer_kind=layer_kind, write=write)
        if "local" not in layer_kind:
            seen[:] = [(q, ck, cv, pos, out, layer_kind)]
        return out

    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    with torch.no_grad():
        for i in range(LONG_STEPS):
            batch["tokens"].copy_(toks[i])
            batch["pos"].fill_(seeded + i)
            if i == LONG_STEPS - 1:
                A.decode_attention = spy
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                logits, _ = fn(params, caches, batch)
                torch.cuda.synchronize()
            finally:
                A.decode_attention = orig
            step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(params, caches, batch)             # the last position again
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    log(f"profile long_500k serve_step: one step, wall {wall_ms:.1f} ms; "
        f"{device_summary(prof, wall_ms, top_n=8)} ({card_line()})")
    del prof
    if logits.shape != (1, 1, cfg.vocab_padded) or not bool(
            torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError("long_500k: bad logits at the last position")

    log(f"long_500k serve_step ({LONG_ARCH}, batch 1, {S} positions, "
        f"{card_line()}): {np.mean(step_ms):.2f} ms a step over "
        f"{LONG_STEPS} steps at positions {seeded}-{S - 1} (each "
        f"{', '.join(f'{x:.2f}' for x in step_ms)}); peak "
        f"{peak / 1e9:.3f} GB allocated against the dry run's "
        f"{want['total'] / 1e9:.3f} GB of arguments")
    # the parameters are done with: the plain version and the yardstick
    # below need room beside the caches
    q, ck, cv, pos, dense, kind = seen[0]
    del params, logits, seen
    gc.collect()
    torch.cuda.empty_cache()
    pool = next(c for c in caches if "k" in c and c["k"].untyped_storage(
    ).data_ptr() == ck.untyped_storage().data_ptr())
    row = _long_paged_row(torch, A, SK, SR, cfg, q, pool, ck, cv, pos,
                          dense, kind, gen)
    del caches, pool, batch, q, ck, cv, dense
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": float(np.mean(step_ms)), "peak_bytes": peak,
            "arg_bytes": want["total"], **row}


def _bf16_ulps(x, n):
    """``n`` bf16 ulps at the largest magnitude of ``x``."""
    return n * 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


def _long_paged_row(torch, A, SK, SR, cfg, q, pool, ck, cv, pos, dense,
                    kind, gen):
    """``paged_decode`` over one global layer's whole long cache (``ck`` /
    ``cv``: [1, S, KVH, hd], super-block ``sb`` of the stacked ``pool``
    {"k", "v"} [n_sb, 1, S, KVH, hd]) seen as pages of LONG_PAGE of the
    whole stacked pool, so its page ids start at ``sb`` x the pages of a
    super-block and its rows ``sb`` GiB into each pool:

    * against that layer's dense attention ``dense`` at the last position
      of the step, within LONG_PAGED_ULPS bf16 ulps of ``dense``'s largest
      element;
    * its time, bound, plain version's time and
      ``scaled_dot_product_attention``'s over the same K / V (no softcap,
      which it cannot apply);
    * with the LONG_PLANTED rows written into the layer's pages for a
      seeded query ``qm``: the port's dense attention (``decode_attention``)
      against the softmax over the planted rows alone, and the kernel
      against that dense attention, each within LONG_PAGED_ULPS ulps; and
      losing any one planted row must move the output by more than four
      times that tolerance, or the check would not see a wrong page."""
    import torch.nn.functional as Fn
    KVH, hd = cfg.n_kv_heads, cfg.hd
    G = cfg.n_heads // KVH
    S = ck.shape[1]
    n_pages = S // LONG_PAGE
    sb = ck.storage_offset() // pool["k"][0].numel()
    if not (pool["k"][sb].data_ptr() == ck.data_ptr()
            and pool["v"][sb].data_ptr() == cv.data_ptr()):
        raise AssertionError("long_500k: the layer's cache is not a "
                             "super-block of the stacked pool")
    offset = sb * pool["k"][0].nbytes
    if offset < 1 << 31:
        raise AssertionError(f"long_500k: the layer's rows start only "
                             f"{offset} bytes into the pool")
    kp, vp = (pool[x].view(-1, LONG_PAGE, KVH, hd) for x in ("k", "v"))
    lists = {"page_idx": sb * n_pages + np.arange(
                 n_pages, dtype=np.int32)[None],
             "counts": np.array([n_pages], np.int32),
             "kv_len": pos.cpu().numpy().astype(np.int32) + 1,
             "starts": np.zeros(1, np.int32)}
    dev_lists = [torch.from_numpy(v).to(q.device) for v in lists.values()]
    q4 = q.reshape(1, KVH, G, hd)

    def call(qq):
        return SK.paged_decode_cuda(qq, kp, vp, *dev_lists,
                                    softcap=cfg.attn_softcap)
    dense = dense.reshape(1, KVH, G, hd).float()
    err = (call(q4).float() - dense).abs().max().item()
    tol = _bf16_ulps(dense, LONG_PAGED_ULPS)
    if not err <= tol:
        raise AssertionError(f"long_500k: paged_decode disagrees with the "
                             f"dense attention (max abs err {err:.4g}, "
                             f"tolerance {tol:.4g})")
    ms = time_ms(torch, lambda: call(q4), 20)
    plain_ms = enqueue_time_ms(torch, lambda: SR.paged_decode_ref(
        q4, kp, vp, *dev_lists, softcap=cfg.attn_softcap), 3)
    k_seq, v_seq = (x.transpose(1, 2) for x in (ck, cv))
    lib_ms = time_ms(torch, lambda: Fn.scaled_dot_product_attention(
        q.reshape(1, cfg.n_heads, 1, hd), k_seq, v_seq, enable_gqa=True), 5)
    del k_seq, v_seq
    (bound, bound_by), n_live = paged_decode_bound(
        q4, lists["page_idx"], lists["counts"], lists["kv_len"],
        lists["starts"], LONG_PAGE)

    # the planted rows: score t for query head g of every KV head
    scale = hd ** -0.5
    qm = torch.randn((1, KVH, G, hd), generator=gen, device=q.device).to(
        q.dtype)
    rows = [p % S for p, _, _ in LONG_PLANTED]
    for p, (_, g, t) in zip(rows, LONG_PLANTED):
        qg = qm[0, :, g].float()                           # [KVH, hd]
        ck[0, p] = (t * qg / (scale * (qg * qg).sum(-1, keepdim=True))).to(
            ck.dtype)
        cv[0, p] = torch.randn((KVH, hd), generator=gen,
                               device=q.device).to(cv.dtype)
    kr, vr = ck[0, rows].float(), cv[0, rows].float()      # [R, KVH, hd]

    def mixture(keep):          # the softmax over the planted rows alone
        s = torch.einsum("kgd,rkd->kgr", qm[0].float(), kr[keep]) * scale
        if cfg.attn_softcap is not None:
            s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
        return torch.einsum("kgr,rkd->kgd", torch.softmax(s, -1), vr[keep])
    mix = mixture(list(range(len(rows))))
    lose = min((mixture([j for j in range(len(rows)) if j != i]) - mix)
               .abs().max().item() for i in range(len(rows)))
    planted = A.decode_attention(qm.reshape(1, 1, cfg.n_heads, hd), ck, cv,
                                 pos, cfg, layer_kind=kind).reshape(
                                     1, KVH, G, hd).float()
    ptol = _bf16_ulps(planted, LONG_PAGED_ULPS)
    mix_err = (planted[0] - mix).abs().max().item()
    perr = (call(qm).float() - planted).abs().max().item()
    row = {"name": "paged_decode", "shape": f"long_500k: B 1, KVH {KVH}, G "
           f"{G}, D {hd}, {n_live} positions in {n_pages} pages of "
           f"{LONG_PAGE}, page ids from {sb * n_pages} ({offset} bytes into "
           f"each pool), bf16, softcap {cfg.attn_softcap}",
           "max_abs_err_vs_dense": err, "tolerance": tol,
           "max_abs_dense": dense.abs().max().item(),
           "planted_rows": rows, "planted_err_vs_dense": perr,
           "planted_dense_vs_mixture": mix_err, "planted_tolerance": ptol,
           "planted_max_abs_dense": planted.abs().max().item(),
           "planted_least_change_losing_a_row": lose,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": bound_by, "library_ms": lib_ms}
    log(f"paged_decode at long_500k against the last global layer's dense "
        f"attention ({LONG_PAGED_ULPS} bf16 ulps of the largest output; "
        f"JSON; {card_line()}): " + json.dumps(row))
    if not (mix_err <= ptol and perr <= ptol and lose > 4 * ptol):
        raise AssertionError("long_500k: with planted rows, paged_decode, "
                             "the dense attention and the planted rows' "
                             "softmax disagree, or losing a row would not "
                             "show")
    return {"paged_err": err, "paged_ms": ms, "paged_plain_ms": plain_ms,
            "paged_bound_ms": bound, "paged_library_ms": lib_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--terms", type=int, default=N_TERMS,
                    help="vocabulary size (cut only if the time limit "
                         "forces it)")
    ap.add_argument("--seed", type=int, default=1402)
    ap.add_argument("--profile-compressed", action="store_true",
                    help="profile two more compressed training steps "
                         "(about 110 s more on an H100)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import repro_torch.obs as obs
    from repro_torch import search as S
    from repro_torch.kernels.roaring import cases
    from repro_torch.kernels.roaring import fused as F
    from repro_torch.kernels.roaring import kernel as K
    from repro_torch.kernels.roaring import ops
    from repro_torch.kernels.roaring import ref
    from repro_torch import serve as SV
    from repro_torch import store as ST
    from repro_torch.core import py_roaring as pr
    from repro_torch.core import torch_roaring as tr
    from repro_torch.roaring import RoaringFormatSpec as FS
    from repro_torch.kernels.build import build, ptxas_report
    from repro_torch.configs import get_config
    from repro_torch.kernels.sparse_attn import cases as pd_cases
    from repro_torch.kernels.sparse_attn import kernel as SK
    from repro_torch.kernels.sparse_attn import ref as SR
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch._tree import tree_map
    from repro_torch.models import mlp as PM
    from repro_torch.models import transformer as T
    from repro_torch.runtime import simulate_failure
    from repro_torch import train as TR
    from repro_torch import baselines as B
    from repro_torch import roaring as RS
    from repro_torch import _tree
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.models import attention as A

    # float32 matmuls and convolutions in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if args.terms != N_TERMS:
        log(f"CUT: vocabulary {args.terms} terms instead of {N_TERMS}")

    t = time.perf_counter()
    build()
    log(f"build: {time.perf_counter() - t:.1f} s (nvcc, sm_90a, in parallel)")
    t = time.perf_counter()
    regs = ptxas_report(("sparse_attn/csrc/paged_decode.cu",
                         "sparse_attn/csrc/sparse_flash.cu",
                         "roaring/csrc/intersect_dispatch.cu",
                         "roaring/csrc/fused_eval.cu",
                         "roaring/csrc/container_ops.cu"))
    log(f"ptxas report of the attention and roaring kernels: {len(regs)} "
        f"kernels, {time.perf_counter() - t:.1f} s")
    log("kernels: " + json.dumps(list(KERNELS)))
    timer_self_test(torch)

    check_kernels(torch, cases, K, ops, ref, F, args.seed)
    check_containers(torch, cases, K, ref, args.seed)
    check_paged_decode(torch, pd_cases, SK, SR, args.seed)
    check_sparse_flash(torch, pd_cases, SK, SR, args.seed)
    t = time.perf_counter()
    launches, index, terms, postings = main_path(torch, S, K, obs,
                                                 args.terms, args.seed)
    captured = capture_inputs(torch, S, K, index, terms, args.seed)
    rows = kernel_rows(torch, K, ref, F, launches, captured, regs)
    where_time_goes(torch, S, obs, index, terms, args.seed)
    del captured
    log(f"search phases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paper, paper_launches = paper_rows(torch, K, B, index, postings, terms)
    log(f"paper phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    sharded_launches = sharded_search(torch, S, K, ops, index, terms,
                                      args.seed)
    del index, postings
    log(f"sharded search phase: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    store, records, store_fused = store_path(torch, ST, K, ref, F, pr, FS,
                                             SSB_SF, args.seed)
    next(r for r in rows if r["name"] == "fused_tree")[
        "store_launches"] = store_fused
    t_db = time.perf_counter()
    paper["db"] = paper_db_pair(torch, K, B, RS, store)
    log(f"paper database pair phase: {time.perf_counter() - t_db:.1f} s")
    log("paper rows (JSON): " + json.dumps(paper))
    rows += container_rows(torch, K, ops, ref, tr, store, records)
    del store, records
    gc.collect()
    torch.cuda.empty_cache()
    log(f"store phases: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    serve_launches, largest, eng, params, serve_rates = serve_path(
        torch, T, SV, LS, SK, cfg, args.seed)
    serve_profile(torch, SV, LS, obs, cfg, params, eng, args.seed)
    del params
    rows.append(paged_decode_rows(torch, SK, SR, cfg, eng, largest,
                                  serve_launches, args.seed, regs))
    del eng, largest
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve phases: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    registry = {"shapes": paged_decode_registry(torch, SK, SR, args.seed)}
    dbrx = dbrx_path(torch, T, PM, SV, LS, SK, SR, obs, args.seed)
    registry["dbrx_launches"] = dbrx["launches"]
    registry["dbrx_serve_launch"] = dbrx["serve_launch"]
    log(f"dbrx phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    state_paths(torch, T, args.seed)
    registry["registry_launches"] = registry_path(torch, T, SK, tree_map,
                                                  args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"rwkv6, whisper and reduced registry phases: "
        f"{time.perf_counter() - t:.1f} s")
    log(f"paged_decode beyond gemma2 (JSON; {card_line()}): "
        + json.dumps(registry))

    t = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), attn_impl="sparse")
    train_launches, params, lists, batch, train_ms = train_path(
        torch, T, SK, SR, TR, cfg, args.seed)
    rows.append(sparse_flash_row(torch, T, SK, SR, cfg, params, lists,
                                 batch, train_launches, regs))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train phases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    comp_launches, comp_ms, _, _ = compressed_train_path(
        torch, TR, K, SK, cfg, params, lists, batch, train_ms,
        profile=args.profile_compressed)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"compressed train phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launcher_path(torch, LT, simulate_failure)
    flop_rates(cfg, train_ms, comp_ms, serve_rates)
    log(f"launcher and FLOP rate phases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    qwen_launches, qwen_row = qwen_train_path(torch, T, SK, SR, TR,
                                              args.seed, regs)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sparse_flash_attention at {QWEN_ARCH}'s training shape (JSON; "
        f"{card_line()}): " + json.dumps(qwen_row))
    log(f"qwen train phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    reg_train_launches = registry_train_path(torch, T, SK, TR, tree_map,
                                             args.seed)
    log(f"registry train phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dryrun_phase(DR)
    log(f"dry run phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    long_cell_path(torch, T, A, SP, DR, SK, SR, _tree, args.seed)
    log(f"long_500k phase: {time.perf_counter() - t:.1f} s")
    by_name = {r["name"]: r for r in rows}
    by_name["intersect_dispatch"]["paper_launches"] = \
        paper_launches["intersect_dispatch"]
    by_name["intersect_dispatch_stacked"]["sharded_launches"] = \
        sharded_launches["intersect_dispatch_stacked"]
    for name in ("intersect_dispatch", "intersect_dispatch_stacked",
                 "sparse_flash_attention"):
        by_name[name]["compressed_train_launches"] = comp_launches[name]
    by_name["sparse_flash_attention"]["qwen_train_launches"] = \
        qwen_launches["sparse_flash_attention"]
    by_name["sparse_flash_attention"]["registry_train_launches"] = \
        reg_train_launches
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
