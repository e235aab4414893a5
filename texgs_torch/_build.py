"""Builds the CUDA sources in texgs_torch/csrc into shared libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v

into ``build/texgs_torch/lib<name>-<hash>.so`` at the repository root, then
loaded with ctypes.  The hash covers the source and the flags, so a changed
source is rebuilt.  ``-Xptxas=-v`` changes no generated code: it only
makes ptxas report each kernel's registers, shared memory and spills, which
``build`` returns and keeps beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "texgs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNEL_SOURCES = ("uvtex_fused", "tex_term")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of texgs_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, as a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of a tensor's device, as a ctypes argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
