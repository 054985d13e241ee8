"""Build and load the port's hand-written CUDA kernels as one library.

Every ``.cu`` source of the kernel packages (``roaring/csrc``,
``sparse_attn/csrc``) compiles with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. Builds happen at
first use, never at import: each source compiles to an object in its own
``nvcc`` process, all started together, and one link makes the library in
``_build/`` next to this file, under a name that hashes the sources, the
headers, the generated dispatch table and the flags, so an edit never
reuses a stale library. Each kernel module declares the argument types of
its own entry points on the loaded handle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

__all__ = ["build", "library", "raise_on", "ptxas_report", "NVCC_FLAGS",
           "SOURCES"]

_ROOT = Path(__file__).resolve().parent
_BUILD = _ROOT / "_build"
SOURCES = ("roaring/csrc/intersect_dispatch.cu", "roaring/csrc/fused_eval.cu",
           "roaring/csrc/container_ops.cu",
           "sparse_attn/csrc/paged_decode.cu",
           "sparse_attn/csrc/sparse_flash.cu")
_HEADERS = ("roaring/csrc/roaring_common.cuh",)
_INCLUDES = ("roaring/csrc", "sparse_attn/csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def _generated() -> dict:
    """Headers made at build time: name -> text."""
    from .roaring.kernel import and_table_source
    return {"and_table.inc": and_table_source()}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def build() -> Path:
    """Build the kernel library unless an up-to-date one exists; returns its
    path. Raises with the compiler's output if a build step fails."""
    gen = _generated()
    digest = hashlib.sha256(b"".join(
        [(_ROOT / f).read_bytes() for f in (*SOURCES, *_HEADERS)]
        + [t.encode() for _, t in sorted(gen.items())]
        + [" ".join(NVCC_FLAGS).encode()])).hexdigest()[:16]
    lib = _BUILD / f"libkernels_{digest}.so"
    if lib.exists():
        return lib
    work = _BUILD / f"{digest}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    for name, text in gen.items():
        (work / name).write_text(text)
    includes = [a for d in _INCLUDES for a in ("-I", str(_ROOT / d))]
    objs = [work / f"{Path(src).stem}.o" for src in SOURCES]
    steps = [(src, subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *includes, "-I", str(work), "-c",
         "-o", str(obj), str(_ROOT / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for src, obj in zip(SOURCES, objs)]
    outs = [(what, p.communicate()[0], p.returncode) for what, p in steps]
    if not any(rc for _, _, rc in outs):
        link = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(work / "lib.so"),
             *map(str, objs)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        outs.append(("link", link.stdout, link.returncode))
    errors = [f"{what}: nvcc exit {rc}\n{out.decode(errors='replace')}"
              for what, out, rc in outs if rc]
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    os.replace(work / "lib.so", lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def ptxas_report(sources) -> dict:
    """Registers a thread and spilled bytes of every kernel in ``sources``
    (paths as in ``SOURCES``), from ``nvcc -Xptxas -v`` with the build's
    flags, one ``nvcc`` per source, all started together: {mangled kernel
    name: (registers, spill stores + loads in bytes)}."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, text in _generated().items():
            (Path(tmp) / name).write_text(text)
        includes = [a for d in _INCLUDES for a in ("-I", str(_ROOT / d))]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *includes, "-I", tmp, "-Xptxas", "-v",
             "-c", "-o", str(Path(tmp) / f"{i}.o"), str(_ROOT / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, src in enumerate(sources)]
        outs = [p.communicate()[0] for p in procs]
    report, name, spill = {}, None, 0
    for line in "\n".join(outs).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), spill)
    return report


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.roaring_error_string.argtypes = [ctypes.c_int]
        lib.roaring_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def raise_on(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().roaring_error_string(err)
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({msg.decode()})")
