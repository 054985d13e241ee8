"""Collective bytes of a cell, counted from its placements.

The reference's ``launch/hlo_analysis.py:105`` ``collective_bytes`` reads
the collectives from the partitioned HLO that XLA compiles for a cell: the
per-device result bytes of each all-gather, reduce-scatter, all-reduce and
all-to-all, each multiplied by the trip counts of the loops around it
(microsteps, super-blocks). The port runs eagerly and has no HLO, so this
module counts the collectives that ``launch.specs.build_cell``'s logical
specs imply, under the model below, in the same unit: per-device result
bytes per step. Every record it makes says ``"source": "placements"``; it
is a model of what a sharded launcher would move, not a trace.

Notation: a mesh of sizes (pod P, data D, model M); ``dp`` ranks carry the
batch (P * D; P * D * M under the "replicate" mode); a step runs
``n_micro`` microsteps of ``rows`` sequences (``rows / dp`` a rank) of
``seq`` positions (1 in decode; train adds the vision stub's patches);
``tok = rows / dp * seq`` tokens a rank and microstep; activations are in
the compute dtype. A training step passes each super-block three times
(the forward, its recompute under remat "full", the backward); prefill and
decode once. The encoder of the encoder-decoder pattern runs in no cell
(its output is the ``memory`` input), so its leaves move nothing.

* FSDP all-gather (data axis): every parameter leaf whose spec names
  "data" is gathered over it before use, once a microstep in prefill and
  decode and twice in training (forward and recompute; the backward uses
  the recompute's copy). Result: the leaf with only its model sharding.
* Gradient reduce-scatter (data axis, training): each such leaf's gradient,
  once a microstep; result: its shard. A leaf not sharded on "data" has
  its gradient all-reduced over the data axes instead (result: its model
  shard). Under "replicate", every gradient is all-reduced over all batch
  axes (result: the whole leaf).
* Gradient all-reduce over "pod" (training): the data shard of each
  data-sharded leaf, once a microstep (the batch is split over pods, the
  parameters are not).
* Row-parallel products (model axis): a product whose contracted dim is
  sharded on "model" (attention and cross-attention ``wo``, MLP ``wo``,
  Mamba ``out_proj`` / ``x_proj``, RWKV ``wo`` / ``cwo``) ends in an
  all-reduce of its output, ``tok x out_dim``, once a layer and pass (in
  training the third is the matching column-parallel product's input
  gradient).
* Vocab-parallel embedding and logits (model axis, embedding table sharded
  on vocab): the lookup ends in an all-reduce of ``tok x d`` in the
  table's dtype, once a microstep. Training's loss all-reduces the
  logsumexp's max and sum and the label logit (``tok`` f32 each), and its
  backward the unembedding's input gradient (``tok x d`` in the wider of
  the compute and table dtypes). Prefill and decode leave the logits
  vocab-sharded: no collective.
* MoE dispatch (model axis, experts sharded on "model"): per MoE layer and
  pass, two all-to-alls (dispatch and combine) of the rank's share of the
  ``[G, E, C, d]`` expert buffer (G groups of tokens, one a data shard;
  ``C = ceil(capacity_factor * tokens_per_group * top_k / E)``).
* Long-context attention (decode): a KV cache sharded on its sequence dim
  ends each attention layer in an all-reduce, over the axes that shard it,
  of the partial softmax: ``B x H x (hd + 2)`` f32 (max, sum and the
  weighted values). A cache sharded on head_dim over "model" all-reduces
  the scores instead: ``B_rank x H x S`` f32 a layer.

What the model leaves out: collectives XLA adds to reshard activations
between differently placed operations, the scalar reductions of the
gradient clip, and Mamba's or RWKV's state when it is sharded on a
feature dim (those stay shard-local in the recurrence).
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

from repro_torch import _tree
from repro_torch.distributed import sharding as sh
from repro_torch.launch.specs import shard_shape
from repro_torch.models import common

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")

# products whose contracted dims carry the leaf's "model" sharding
_ROW_PARALLEL = re.compile(r"(attn/wo|mlp/wo|mamba/out_proj|mamba/x_proj|"
                           r"tm/wo|tm/cwo)$")
_UNUSED = ("encoder", "enc_norm")


def _names(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def _without(spec: tuple, axis: str) -> tuple:
    out = []
    for ax in spec:
        rest = tuple(a for a in _names(ax) if a != axis)
        out.append(None if not rest else rest if len(rest) > 1 else rest[0])
    return tuple(out)


def _bytes(t, spec, sizes) -> int:
    return math.prod(shard_shape(t.shape, spec, sizes)) * t.element_size()


def cell_collectives(cfg, kind: str, args, specs, mesh, *, seq_len: int,
                     global_batch: int, microbatch=None,
                     mode: str = "auto", seq_extra: int = 0) -> dict:
    """``{"source", "per_kind", "per_axes", "counts", "per_device_bytes",
    "trip_counts"}`` of one cell built by ``build_cell`` (``args`` /
    ``specs`` as it returns them). ``per_kind``: bytes a rank receives
    per step, by collective kind; ``per_axes``: the same by the mesh
    dimensions the collective spans ("pod+data", ...); ``counts``:
    collectives a step, by kind. ``seq_extra``: positions added in front
    of the tokens (the vision stub's patches in training)."""
    sizes = sh.mesh_sizes(mesh)
    names = ("pod", "data", "model") if mode == "replicate" else ("pod",
                                                                  "data")
    batch_axes = tuple(a for a in names if a in sizes)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in batch_axes)
    M = sizes.get("model", 1)
    train, decode = kind == "train", kind == "decode"
    n_micro = global_batch // microbatch if microbatch else 1
    rows = microbatch or global_batch
    rows_rank = -(-rows // dp) if rows > 1 else rows
    seq = 1 if decode else seq_len + (seq_extra if train else 0)
    tok = rows_rank * seq
    cbytes = common.dtype_of(cfg.compute_dtype).itemsize
    passes = 3 if train else 1

    per_kind = defaultdict(float)
    per_axes = defaultdict(float)
    counts = defaultdict(int)

    def add(what, axes, nbytes, times):
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if not axes or times <= 0:
            return
        per_kind[what] += nbytes * times
        per_axes["+".join(axes)] += nbytes * times
        counts[what] += times

    params, params_sh = args[0], specs[0]
    if train:
        params, params_sh = params["params"], params_sh["params"]
    for (path, t), spec in zip(_tree.leaves_with_paths(params),
                               _tree.leaf_nodes(params, params_sh)):
        if path[0] in _UNUSED:
            continue
        p = "/".join(str(x) for x in path)
        on_data = any("data" in _names(ax) for ax in spec)
        if on_data:
            add("all-gather", ("data",), _bytes(t, _without(spec, "data"),
                                                sizes),
                (2 if train else 1) * n_micro)
        if train:
            if on_data:
                add("reduce-scatter", ("data",), _bytes(t, spec, sizes),
                    n_micro)
                add("all-reduce", ("pod",), _bytes(t, spec, sizes), n_micro)
            else:
                add("all-reduce", batch_axes, _bytes(t, spec, sizes),
                    n_micro)
        model_in = any("model" in _names(ax) for ax in spec[1:t.dim() - 1])
        if _ROW_PARALLEL.search(p) and model_in:
            add("all-reduce", ("model",), tok * t.shape[-1] * cbytes,
                passes * n_micro * t.shape[0])
        if p == "embed/table" and spec and "model" in _names(spec[0]):
            d = t.shape[1]
            add("all-reduce", ("model",), tok * d * t.element_size(),
                n_micro)
            if train:
                add("all-reduce", ("model",), tok * 4, 3 * n_micro)
                wide = max(cbytes, t.element_size())
                add("all-reduce", ("model",), tok * d * wide, n_micro)
        if p.endswith("moe/wi") and len(spec) > 1 and "model" in _names(
                spec[1]):
            n_layers, E, d = t.shape[0], t.shape[1], t.shape[2]
            G = math.prod(sizes[a] for a in batch_axes)
            if rows % G:
                G = 1
            C = max(1, math.ceil(cfg.capacity_factor * rows * seq / G
                                 * cfg.top_k / E))
            share = -(-G // dp) * -(-E // M) * C * d * cbytes
            add("all-to-all", ("model",), share,
                2 * passes * n_micro * n_layers)

    if decode:
        for cache, cspec in zip(args[1], specs[1]):
            if "k" not in cache:
                continue
            t, spec = cache["k"], cspec["k"]
            n_layers, B = t.shape[0], t.shape[1]
            H, hd = cfg.n_heads, cfg.hd
            if len(spec) > 2 and spec[2] is not None:
                add("all-reduce", _names(spec[2]), B * H * (hd + 2) * 4,
                    n_layers)
            elif len(spec) > 4 and spec[4] == "model":
                b_rank = -(-B // dp) if spec[1] is not None else B
                add("all-reduce", ("model",), b_rank * H * t.shape[2] * 4,
                    n_layers)

    return {"source": "placements",
            "per_kind": {k: per_kind[k] for k in KINDS if k in per_kind},
            "per_axes": dict(per_axes),
            "counts": {k: counts[k] for k in KINDS if k in counts},
            "per_device_bytes": float(sum(per_kind.values())),
            "trip_counts": {"microsteps": n_micro,
                            "superblocks": cfg.n_superblocks}}
