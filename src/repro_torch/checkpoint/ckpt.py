"""Checkpoints of nested dicts of tensors, in the reference's on-disk layout.

Layout (one directory per step), as the reference writes it:
    ckpt_dir/step_000123/
        manifest.json        — structure, shapes, dtypes, chunking, meta
        shard_00000.npz      — flat leaves (chunked by byte budget)
        ...

Leaves are numbered in the reference's flattening order (sorted dict keys,
lists in order; ``repro_torch._tree``), and bfloat16 leaves are stored as
their raw uint16 bits under the dtype name ``bfloat16``, so the reference's
``restore_checkpoint`` reads a port checkpoint leaf for leaf, and the other
way round. The manifest's ``treedef`` describes the structure in the port's
own words (the reference writes JAX's).

  * writes go to a temp dir + atomic rename, so a mid-save failure never
    corrupts the latest checkpoint;
  * ``AsyncCheckpointer`` copies to host memory synchronously (the train
    step then updates the live tensors in place) and writes in a
    background thread;
  * data-pipeline state lives in the manifest's ``extra`` for exact restart.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import _tree

_CHUNK_BYTES = 256 * 1024 * 1024


def _to_numpy(leaf) -> tuple:
    """A leaf as a host numpy copy in its stored form, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), \
                "bfloat16"
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_tensor(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous save: atomic per-step directory."""
    leaves = _tree.leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": _tree.describe(tree),
                "n_leaves": len(leaves), "extra": extra or {}, "leaves": []}
    shard_id = 0
    buf: dict[str, np.ndarray] = {}
    buf_bytes = 0
    for i, leaf in enumerate(leaves):
        arr, dtype_name = _to_numpy(leaf)
        manifest["leaves"].append({
            "index": i, "shape": list(arr.shape), "dtype": dtype_name,
            "shard": shard_id, "key": f"leaf_{i}"})
        buf[f"leaf_{i}"] = arr
        buf_bytes += arr.nbytes
        if buf_bytes >= _CHUNK_BYTES:
            np.savez(os.path.join(tmp, f"shard_{shard_id:05d}.npz"), **buf)
            buf, buf_bytes = {}, 0
            shard_id += 1
    if buf:
        np.savez(os.path.join(tmp, f"shard_{shard_id:05d}.npz"), **buf)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like``: each leaf comes back as a new
    tensor on the device of ``like``'s leaf at the same place. Returns
    (tree, extra, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _tree.leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint holds {manifest['n_leaves']} leaves, "
                         f"the tree {len(like_leaves)}")
    shards: dict[int, Any] = {}
    leaves = []
    try:
        for meta, lk in zip(manifest["leaves"], like_leaves):
            sid = meta["shard"]
            if sid not in shards:
                shards[sid] = np.load(os.path.join(d, f"shard_{sid:05d}.npz"))
            leaves.append(_to_tensor(shards[sid][meta["key"]], meta["dtype"],
                                     lk))
    finally:
        for z in shards.values():
            z.close()
    return _tree.unflatten(like, leaves), manifest["extra"], step


class AsyncCheckpointer:
    """Copy to host synchronously, write in a background thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _tree.tree_map(_host_copy, tree)              # snapshot

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:           # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
