"""Bind and launch the hand-written CUDA kernels of ``csrc/``.

The sources build with the port's other kernels into one library
(``repro_torch.kernels.build``), at first use, never at import.

Wrappers take CUDA tensors only, check dtype / shape / contiguity, allocate
the outputs, launch on PyTorch's current stream and raise if the launch
returned an error. Each adds one to its entry's count in ``launch_counts``
where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import build as _build
from . import dispatch as D
from . import fused as F

__all__ = ["and_table_source", "launch_counts",
           "reset_launch_counts", "intersect_dispatch_cuda", "stacked_plan",
           "fused_eval_cuda", "fused_launch_shape", "fused_shapes",
           "fused_smem", "container_op_cuda", "array_intersect_cuda",
           "CONTAINER_OPS"]

# row-kernel ids of the CUDA cell switch (RK_* in and_table.inc)
_KERNEL_IDS = {"gallop": 1, "probe": 2, "word_and": 3, "run_gallop": 4,
               "run_mask": 5, "run_cov_and": 6}

launch_counts: Dict[str, int] = {"intersect_dispatch": 0,
                                 "intersect_dispatch_stacked": 0,
                                 "fused_tree": 0, "container_op": 0,
                                 "array_intersect": 0}

# word ops of the container_op kernel, by their id in container_ops.cu
CONTAINER_OPS = {"and": 0, "or": 1, "xor": 2, "andnot": 3}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def and_table_source() -> str:
    """The CUDA cell switch, generated from ``dispatch.AND_TABLE``: per
    (kind_a, kind_b) the row-kernel id (0 = no cell: an empty side) and
    whether the kernel sees the operands swapped."""
    kid = [[0] * 4 for _ in range(4)]
    swap = [[0] * 4 for _ in range(4)]
    for cls in D.AND_TABLE:
        kid[cls.kind_a][cls.kind_b] = _KERNEL_IDS[cls.kernel]
        swap[cls.kind_a][cls.kind_b] = int(cls.swap)

    def table(rows):
        return "{" + ", ".join(
            "{" + ", ".join(str(v) for v in r) + "}" for r in rows) + "}"

    lines = ["// generated from repro_torch.kernels.roaring.dispatch.AND_TABLE",
             "#pragma once", "#define RK_NONE 0"]
    lines += [f"#define RK_{name.upper()} {i}"
              for name, i in sorted(_KERNEL_IDS.items(), key=lambda kv: kv[1])]
    lines += [f"__constant__ int AND_KERNEL[4][4] = {table(kid)};",
              f"__constant__ int AND_SWAP[4][4] = {table(swap)};", ""]
    return "\n".join(lines)


_LIB: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library()
        lib.roaring_intersect_dispatch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P]
        lib.roaring_intersect_dispatch.restype = ctypes.c_int
        lib.roaring_stacked_card.argtypes = [
            _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, _P]
        lib.roaring_stacked_card.restype = ctypes.c_int
        lib.roaring_fused_eval.argtypes = [
            _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
        lib.roaring_fused_eval.restype = ctypes.c_int
        lib.roaring_fused_smem.argtypes = [_P, _P]
        lib.roaring_fused_smem.restype = ctypes.c_int
        lib.roaring_container_op.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
        lib.roaring_container_op.restype = ctypes.c_int
        lib.roaring_array_intersect.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_longlong, _P]
        lib.roaring_array_intersect.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return _P(t.data_ptr()) if t is not None else _P(None)


def _stream(t: torch.Tensor):
    return _P(torch.cuda.current_stream(t.device).cuda_stream)


_N_SM: Dict[int, int] = {}


def _n_sm(device) -> int:
    idx = torch.device(device).index or 0
    if idx not in _N_SM:
        props = torch.cuda.get_device_properties(idx)
        _N_SM[idx] = props.multi_processor_count
    return _N_SM[idx]


def stacked_plan(n: int, c: int, n_sm: int):
    """``(split, lanes)`` of the card-only launch over ``n`` slabs x ``c``
    query rows: its grid is ``c x split`` blocks of 256 threads (each
    stages its column's query once), and ``lanes`` threads share a pair.

    From the shapes and the SM count alone, never the data: enough blocks
    for two waves at 8 resident blocks an SM, but no more than one block
    per 64 of a column's pairs; then 8 lanes a pair where that still
    leaves each of the block's 32 pair groups two pairs or more (a group
    loads its next pair's meta while it works on one), else a warp."""
    split = max(1, min(-(-2 * 8 * n_sm // max(c, 1)), -(-n // 64), 65535))
    return split, (8 if 2 * split * 32 <= n else 32)


def intersect_dispatch_cuda(a: torch.Tensor, b: torch.Tensor,
                            meta: torch.Tensor, *,
                            entry: str = "intersect_dispatch",
                            want_hits: bool = True):
    """Launch a dispatch kernel over ``R = a.shape[0]`` pairs.

    a: int16[R, 4096]; b: int16[Rb, 4096] with ``R % Rb == 0`` — pair ``r``
    reads b row ``r % Rb`` (Rb = R for key-aligned pairs, Rb = C for a
    query shared by every slab of a stack); meta: i32[6R]. Returns
    ``(hits int16[R, 4096] or None, card i32[R])``; ``entry`` names the
    launch counter. With ``want_hits`` the key-aligned kernel runs (one
    block per pair); without, the card-only kernel (8 or 32 lanes a pair, the
    query's rows staged once per block; ``stacked_plan``), which reads the
    b-side fields (kind_b, card_b, nruns_b) of pair ``r % Rb`` for every
    pair of that column, as ``ops.stacked_and_card`` builds them.
    """
    _check(a, torch.int16, "a")
    _check(b, torch.int16, "b")
    _check(meta, torch.int32, "meta")
    R, Rb = a.shape[0], b.shape[0]
    if a.shape[1:] != (D.ROW_WORDS,) or b.shape[1:] != (D.ROW_WORDS,):
        raise ValueError("rows must be 4096 u16 words")
    if Rb == 0 or R % Rb or meta.numel() != D.META_FIELDS * R:
        raise ValueError(f"bad shapes: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, meta {tuple(meta.shape)}")
    card = torch.empty((R,), dtype=torch.int32, device=a.device)
    if want_hits:
        hits = torch.empty((R, D.ROW_WORDS), dtype=torch.int16,
                           device=a.device)
        err = _lib().roaring_intersect_dispatch(
            _ptr(a), _ptr(b), _ptr(meta), _ptr(hits), _ptr(card), R, Rb,
            _stream(a))
    else:
        hits = None
        split, lanes = stacked_plan(R // Rb, Rb, _n_sm(a.device))
        err = _lib().roaring_stacked_card(
            _ptr(a), _ptr(b), _ptr(meta), _ptr(card), R // Rb, Rb, split,
            lanes, _stream(a))
    _build.raise_on(err, entry)
    launch_counts[entry] += 1
    return hits, card


_SMEM: Dict[int, Tuple[int, int]] = {}


def fused_smem(device) -> Tuple[int, int]:
    """(bytes a fused block can take beside its static shared memory,
    shared memory bytes per SM) on ``device``."""
    idx = torch.device(device).index or 0
    if idx not in _SMEM:
        block, sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(idx):
            if not _lib().roaring_fused_smem(ctypes.byref(block),
                                             ctypes.byref(sm)):
                raise RuntimeError("fused_tree: cannot read the device's "
                                   "shared memory sizes")
        _SMEM[idx] = (block.value, sm.value)
    return _SMEM[idx]


def _fused_block_bytes(n_lifts: int, stack: int, split: int) -> int:
    """Dynamic shared memory of a fused block: 16 bytes of tags an operand,
    then the lifted rows and the stack, 8 kB / ``split`` a row."""
    return 16 * n_lifts + (n_lifts + stack) * 2 * D.ROW_WORDS // split


def fused_shapes(n_lifts: int, n_slots: int,
                 smem_block: int) -> Tuple[Tuple[int, int, bool], ...]:
    """Every ``(split, stack_rows, in_smem)`` the fused kernel is built for
    that a plan of ``n_lifts`` distinct operands and ``n_slots`` slots can
    take: split 1 or 2 in shared memory where its tags, lifted rows and
    stack (``n_slots - 1`` rows, at least ``split``: the stack's first 8 kB
    stage packed values) fit a block, and split 1 in global scratch."""
    out = []
    for split in (1, 2):
        stack = max(n_slots - 1, split)
        if _fused_block_bytes(n_lifts, stack, split) <= smem_block:
            out.append((split, stack, True))
    return tuple(out) + ((1, max(n_slots - 1, 1), False),)


def fused_launch_shape(n_lifts: int, n_slots: int, smem_block: int,
                       smem_sm: int) -> Tuple[int, int, bool]:
    """``(split, stack_rows, in_smem)`` of a fused launch over ``n_lifts``
    distinct operands and a plan of ``n_slots`` slots, from those shapes
    and the device's shared memory alone: a block owns its column's whole
    row while two such blocks fit an SM (split 1); else half of it, in a
    cluster of two (split 2, half the shared memory a block); a plan that
    does not fit even so keeps its rows in global scratch."""
    stack = max(n_slots - 1, 1)
    # the SM keeps 1 kB of its shared memory for each resident block
    if 2 * (_fused_block_bytes(n_lifts, stack, 1) + 1024) <= smem_sm:
        return 1, stack, True
    return next(s for s in fused_shapes(n_lifts, n_slots, smem_block)
                if s[0] == 2 or not s[2])


def fused_eval_cuda(ops: torch.Tensor, meta: torch.Tensor,
                    plan: F.FusedPlan, shape=None):
    """Launch the fused tree kernel: ops int16[N, C, 4096], meta the
    ``pack_lift_meta`` block. Returns (bits int16[C, 4096], card i32[C]).
    ``shape`` (one of ``fused_shapes``; for tests and tools) overrides
    ``fused_launch_shape``'s; a plan whose rows exceed shared memory runs
    with a global scratch buffer."""
    _check(ops, torch.int16, "ops")
    _check(meta, torch.int32, "meta")
    N, C = ops.shape[0], ops.shape[1]
    if ops.shape[2:] != (D.ROW_WORDS,) or N < plan.n_operands:
        raise ValueError(f"bad operand shape {tuple(ops.shape)} for a plan "
                         f"of {plan.n_operands} operands")
    if meta.numel() != F.LIFT_META_FIELDS * N * C + C:
        raise ValueError(f"bad meta length {meta.numel()}")
    n = len(F.kernel_program(plan)[0])
    split, stack_rows, in_smem = shape or fused_launch_shape(
        n, plan.n_slots, *fused_smem(ops.device))
    lifts, prog = F.encode_program(plan, D.ROW_WORDS // 8 // split,
                                   ops.device)
    scratch = None
    if not in_smem:
        scratch = torch.empty((C * ((n + stack_rows) * D.ROW_WORDS // 2
                                    + 4 * n),),
                              dtype=torch.int32, device=ops.device)
    bits = torch.empty((C, D.ROW_WORDS), dtype=torch.int16, device=ops.device)
    card = torch.empty((C,), dtype=torch.int32, device=ops.device)
    err = _lib().roaring_fused_eval(
        _ptr(ops), _ptr(meta), _ptr(prog), prog.shape[0] - F.PROGRAM_PAD,
        _ptr(lifts), n, N, C, stack_rows, split, _ptr(bits),
        _ptr(card), _ptr(scratch), _stream(ops))
    _build.raise_on(err, "fused_tree")
    launch_counts["fused_tree"] += 1
    return bits, card


def _check_pair_rows(a: torch.Tensor, b: torch.Tensor, tags: torch.Tensor,
                     tag_name: str) -> int:
    _check(a, torch.int16, "a")
    _check(b, torch.int16, "b")
    _check(tags, torch.int32, tag_name)
    R = a.shape[0]
    if (a.dim() != 2 or a.shape[1] != D.ROW_WORDS or b.shape != a.shape
            or tags.numel() != 2 * R):
        raise ValueError(f"bad shapes: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, {tag_name} {tuple(tags.shape)}")
    return R


def container_op_cuda(a: torch.Tensor, b: torch.Tensor, kinds: torch.Tensor,
                      op: str):
    """Launch the word-op kernel over ``R = a.shape[0]`` key-aligned pairs of
    bitmap-domain rows: a, b int16[R, 4096]; kinds i32[2R] interleaved
    (kind_a, kind_b). Returns ``(out int16[R, 4096], card i32[R])``; a
    both-EMPTY pair gives zeros and card 0 without reading its payload."""
    if op not in CONTAINER_OPS:
        raise ValueError(f"unknown container op {op!r} (want one of "
                         f"{sorted(CONTAINER_OPS)})")
    R = _check_pair_rows(a, b, kinds, "kinds")
    out = torch.empty((R, D.ROW_WORDS), dtype=torch.int16, device=a.device)
    card = torch.empty((R,), dtype=torch.int32, device=a.device)
    err = _lib().roaring_container_op(_ptr(a), _ptr(b), _ptr(kinds),
                                      _ptr(out), _ptr(card), R,
                                      CONTAINER_OPS[op], _stream(a))
    _build.raise_on(err, "container_op")
    launch_counts["container_op"] += 1
    return out, card


def array_intersect_cuda(a: torch.Tensor, b: torch.Tensor,
                         cards: torch.Tensor):
    """Launch the packed-array intersection kernel over ``R = a.shape[0]``
    pairs: a, b int16[R, 4096] packed sorted arrays (0xFFFF padded); cards
    i32[2R] interleaved (card_a, card_b), each in [0, 4096]. Returns
    ``(hits int16[R, 4096] 0/1 over A's slots, count i32[R])``."""
    R = _check_pair_rows(a, b, cards, "cards")
    hits = torch.empty((R, D.ROW_WORDS), dtype=torch.int16, device=a.device)
    count = torch.empty((R,), dtype=torch.int32, device=a.device)
    err = _lib().roaring_array_intersect(_ptr(a), _ptr(b), _ptr(cards),
                                         _ptr(hits), _ptr(count), R,
                                         _stream(a))
    _build.raise_on(err, "array_intersect")
    launch_counts["array_intersect"] += 1
    return hits, count
