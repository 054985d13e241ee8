"""Bind and launch the hand-written attention CUDA kernels of ``csrc/``.

``paged_decode.cu`` and ``sparse_flash.cu`` build with the port's other
kernels into one library (``repro_torch.kernels.build``), at first use,
never at import. Each wrapper takes CUDA tensors only, checks dtype /
shape / contiguity, allocates the output, launches on PyTorch's current
stream and raises if the launch returned an error. It adds one to its own
``launch_counts`` entry where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import build as _build

__all__ = ["launch_counts", "reset_launch_counts", "paged_decode_cuda",
           "sparse_flash_attention_cuda", "decode_split", "decode_rows",
           "MAX_GROUP", "GROUP_CHUNK", "MAX_HEAD_DIM", "DECODE_MMA_HEAD_DIMS",
           "DECODE_MMA_HEADS", "DECODE_SPLITS", "FLASH_HEAD_DIMS",
           "FLASH_Q_TILE", "FLASH_KV_TILE"]

MAX_GROUP = 16          # query heads per KV head (kMaxGroup in the source)
# paged_decode.cu picks its split kernel by shape. bf16 at a head dim of
# DECODE_MMA_HEADS runs the tensor-core kernel (mma_split_kernel): all G <=
# MAX_GROUP query heads of a KV head are the M of one mma, and a block
# serves DECODE_MMA_HEADS[D] neighbouring KV heads (kHeads in the source:
# four at D <= 80, whose 128 / 160-byte rows share 256-byte L2 lines with
# the next head's; one at 128). f32, and bf16 at other head dims
# (gemma2-2b's 256), run the CUDA-core kernel (split_kernel).
DECODE_MMA_HEADS = {64: 4, 80: 4, 128: 1}
DECODE_MMA_HEAD_DIMS = tuple(DECODE_MMA_HEADS)
# the most query heads one CUDA-core split block serves (kMaxG in the
# source); a larger G runs there as ceil(G / GROUP_CHUNK) equal chunks of
# blocks, each reading the KV head's K / V. The tensor-core kernel has no
# chunks.
GROUP_CHUNK = 8
MAX_HEAD_DIM = 256      # kMaxD in the source
# paged_decode.cu: the positions one split block may own, largest first, and
# the blocks per SM the split length is cut down for. Long splits write and
# merge fewer partials at decode_32k and long_500k; the blocks-per-SM floor
# keeps two waves or more of either kernel's blocks on the card.
DECODE_SPLITS = (2048, 1024, 512, 256, 128, 64)
DECODE_BLOCKS_PER_SM = 8
# sparse_flash.cu: the head dims it is built for (80: stablelm-3b), the
# query rows of one block (block_q is a multiple) and the keys of one
# sub-tile (block_kv is)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
FLASH_Q_TILE = 64
FLASH_KV_TILE = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts: Dict[str, int] = {"paged_decode": 0,
                                 "sparse_flash_attention": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_LIB: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library()
        lib.sparse_attn_paged_decode.argtypes = (
            [_P] * 9 + [_I] * 8 + [ctypes.c_float, ctypes.c_float, _I, _P])
        lib.sparse_attn_paged_decode.restype = ctypes.c_int
        lib.sparse_attn_sparse_flash.argtypes = (
            [_P] * 6 + [_I] * 10 + [ctypes.c_float, ctypes.c_float, _I, _P])
        lib.sparse_attn_sparse_flash.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, dtype, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device} (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def decode_rows(B: int, KVH: int, G: int, D: int,
                dtype: torch.dtype) -> int:
    """Split blocks of ``paged_decode_cuda`` per split: on the tensor-core
    kernel (bf16, D in ``DECODE_MMA_HEAD_DIMS``) one a group of
    ``DECODE_MMA_HEADS[D]`` KV heads of a sequence, else one a chunk of
    ``GROUP_CHUNK`` of the ``G`` query heads of a (sequence, KV head)."""
    if dtype == torch.bfloat16 and D in DECODE_MMA_HEADS:
        return B * -(-KVH // DECODE_MMA_HEADS[D])
    return B * KVH * -(-G // GROUP_CHUNK)


def decode_split(rows: int, positions: int, n_sm: int) -> int:
    """Positions per split block of ``paged_decode_cuda``: the largest of
    ``DECODE_SPLITS`` that still gives ``DECODE_BLOCKS_PER_SM`` blocks per
    SM over the ``positions`` (``page_idx.shape[1] * page_size``) of each
    of the ``rows`` (``decode_rows``), else the smallest. Known on the host
    from shapes alone, so the wrapper never waits on ``lengths``."""
    for n in DECODE_SPLITS[:-1]:
        if rows * -(-positions // n) >= DECODE_BLOCKS_PER_SM * n_sm:
            return n
    return DECODE_SPLITS[-1]


_SM_COUNT: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_idx: torch.Tensor,
                      counts: torch.Tensor, lengths: torch.Tensor,
                      starts: torch.Tensor, *, softcap: Optional[float] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Launch the paged decode kernel.

    q: [B, KVH, G, D] float32 or bfloat16; k_pages / v_pages: [P,
    page_size, KVH, D] of q's dtype; page_idx: int32[B, max_pages] with ids
    in [0, P) in the first ``counts[b]`` entries; counts / lengths / starts:
    int32[B]. Returns out [B, KVH, G, D] in q's dtype. G <= 16, D <= 256
    and D * itemsize a multiple of 16 bytes. bf16 at D in
    ``DECODE_MMA_HEAD_DIMS`` runs on the tensor cores, one block for all G
    query heads of a KV head; f32 and other head dims on the CUDA cores,
    above 8 query heads in chunks of blocks (``decode_rows``). Two
    launches (the split blocks and their combine) over an f32 workspace
    that this wrapper allocates; one count.
    """
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor (got {q.device})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16 (got {q.dtype})")
    dev = q.device
    for t, name in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        _check(t, q.dtype, name, dev)
    for t, name in ((page_idx, "page_idx"), (counts, "counts"),
                    (lengths, "lengths"), (starts, "starts")):
        _check(t, torch.int32, name, dev)
    B, KVH, G, D = q.shape
    P, page_size = k_pages.shape[0], k_pages.shape[1]
    if (k_pages.shape != (P, page_size, KVH, D)
            or v_pages.shape != k_pages.shape or page_idx.dim() != 2
            or page_idx.shape[0] != B or page_idx.shape[1] < 1
            or any(t.shape != (B,) for t in (counts, lengths, starts))):
        raise ValueError(
            f"bad shapes: q {tuple(q.shape)}, pools {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}, page_idx {tuple(page_idx.shape)}, "
            f"counts / lengths / starts {tuple(counts.shape)} / "
            f"{tuple(lengths.shape)} / {tuple(starts.shape)}")
    if not (1 <= G <= MAX_GROUP and 1 <= D <= MAX_HEAD_DIM
            and (D * q.element_size()) % 16 == 0):
        raise ValueError(f"unsupported G = {G}, D = {D} for {q.dtype}")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    max_pages = page_idx.shape[1]
    split = decode_split(decode_rows(B, KVH, G, D, q.dtype),
                         max_pages * page_size, _sm_count(dev))
    n_splits = -(-max_pages * page_size // split)
    # per (sequence, KV head, split, query head): (m, l), then acc[D]
    ws = torch.empty(B * KVH * n_splits * G * (D + 2), dtype=torch.float32,
                     device=dev)
    out = torch.empty_like(q)
    err = _lib().sparse_attn_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_idx.data_ptr(), counts.data_ptr(), lengths.data_ptr(),
        starts.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, KVH, G, D, P, page_size, max_pages, split,
        D ** -0.5 if scale is None else scale,
        0.0 if softcap is None else softcap, _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "paged_decode")
    launch_counts["paged_decode"] += 1
    return out


def sparse_flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, kv_idx: torch.Tensor,
                                counts: torch.Tensor, *, block_q: int = 128,
                                block_kv: int = 128, causal: bool = True,
                                softcap: Optional[float] = None,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Launch the block-sparse flash attention forward.

    q: [B, H, S, D] float32 or bfloat16; k / v: [B, KVH, S_kv, D] of q's
    dtype, H a multiple of KVH; kv_idx: int32[S / block_q, max_active],
    the listed KV block ids of each q-block row in its first ``counts[qb]``
    entries; counts: int32[S / block_q]. Returns out [B, H, S, D] in q's
    dtype. D in ``FLASH_HEAD_DIMS``; block_q a multiple of
    ``FLASH_Q_TILE``, block_kv of ``FLASH_KV_TILE``. bfloat16 runs on the
    tensor cores, float32 on the CUDA cores (in f32 throughout).
    """
    if not q.is_cuda:
        raise ValueError(f"q must be a CUDA tensor (got {q.device})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16 (got {q.dtype})")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, q.dtype, name, dev)
    for t, name in ((kv_idx, "kv_idx"), (counts, "counts")):
        _check(t, torch.int32, name, dev)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k {tuple(k.shape)}")
    B, H, S, D = q.shape
    KVH, S_kv = k.shape[1], k.shape[2]
    if (k.shape != (B, KVH, S_kv, D) or v.shape != k.shape or KVH < 1
            or H % KVH or kv_idx.dim() != 2 or kv_idx.shape[1] < 1
            or block_q % FLASH_Q_TILE or block_kv % FLASH_KV_TILE
            or block_q < 1 or block_kv < 1 or S % block_q or S_kv % block_kv
            or kv_idx.shape[0] != S // block_q
            or counts.shape != (S // block_q,)):
        raise ValueError(
            f"bad shapes: q {tuple(q.shape)}, k / v {tuple(k.shape)} / "
            f"{tuple(v.shape)}, kv_idx {tuple(kv_idx.shape)}, counts "
            f"{tuple(counts.shape)}, block_q {block_q}, block_kv {block_kv}")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"unsupported head dim {D} (built for "
                         f"{FLASH_HEAD_DIMS})")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    out = torch.empty_like(q)
    err = _lib().sparse_attn_sparse_flash(
        *(_P(t.data_ptr()) for t in (q, k, v, kv_idx, counts, out)),
        B, H, KVH, S, S_kv, D, kv_idx.shape[1], block_q, block_kv,
        int(bool(causal)), D ** -0.5 if scale is None else scale,
        0.0 if softcap is None else softcap, _DTYPES[q.dtype],
        _P(torch.cuda.current_stream(dev).cuda_stream))
    _build.raise_on(err, "sparse_flash_attention")
    launch_counts["sparse_flash_attention"] += 1
    return out
