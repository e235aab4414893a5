"""Builds the CUDA sources in texgs_torch/csrc into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into ``build/texgs_torch/lib<name>-<hash>.so`` at the repository root, then
loaded with ctypes.  The hash covers the source, every header of csrc/ it
includes (``#include "<header>"``, followed through headers) and the flags,
so a changed source or shared header is rebuilt.  ``-Xptxas=-v`` changes no generated code: it only
makes ptxas report each kernel's registers, shared memory and spills, which
``build`` returns and keeps beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "texgs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNEL_SOURCES = ("uvtex_fused", "uvtex_fused_bwd", "tex_term", "tex_term_bwd",
                  "hash_gather", "raster", "raster_bwd", "uvtex_mlist",
                  "uvtex_mlist_bwd", "hash_encode", "hash_encode_bwd",
                  "cubemap_maps", "project", "project_bwd")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of texgs_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def sources_of(name: str) -> list[Path]:
    """csrc/<name>.cu and the csrc headers it includes, directly or through
    another header, in the order first met."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / h for h in _INCLUDE.findall(path.read_text())
                 if (CSRC / h).exists()]
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together.  Returns each source's ptxas report ("" for
    a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        running[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (so, tmp, proc) in running.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        so.with_name(so.name + ".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def function(name: str, fn_name: str, argtypes):
    """The C function ``fn_name`` of csrc/<name>.cu's library, its argument
    types declared (``ctypes.c_void_p`` for pointers, so none is cut to 32
    bits) and its result an int, the launch's cudaError_t."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of a tensor's device, as a ctypes argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
