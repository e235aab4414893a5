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

Every wrapper calls its C entry through ``launch``, after checking its
tensors with ``require``: a kernel is a ``csrc/<name>.cu`` and a wrapper
that does those two things, its plain version beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "texgs_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
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


def kernel_sources() -> list[str]:
    """The stem of every csrc/*.cu: the sources ``build`` compiles."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def build(names=None) -> dict[str, str]:
    """Compile the named sources (every kernel source by default) that are
    not built yet, one nvcc process each, all started together.  Returns
    each source's ptxas report ("" for a library that was already built)."""
    names = kernel_sources() if names is None else names
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


_CTYPES = {"P": ctypes.c_void_p, "i": ctypes.c_int}


def function(name: str, fn_name: str, signature: str):
    """The C function ``fn_name`` of csrc/<name>.cu's library, its argument
    types declared once from ``signature``, a letter an argument: ``P`` a
    pointer (``ctypes.c_void_p``, so none is cut to 32 bits), ``i`` an int.
    Its result is an int, the launch's cudaError_t."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
    return fn


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of a tensor's device, as a ctypes argument
    (a tensor on another device than CUDA is refused here)."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(source: str, entry: str, signature: str, *args, like,
           counter=None, launched: bool = True) -> None:
    """Calls the C entry ``entry`` of csrc/<source>.cu with ``args`` and,
    last, the current CUDA stream of ``like``'s device.  ``signature`` types
    ``args`` as ``function`` reads it.  A tensor passes its device pointer,
    a numpy array its host address (the array lives until the call
    returns), None a null pointer.  Raises RuntimeError on a nonzero
    cudaError_t; after a call that succeeded, adds one to
    ``counter.launches`` where ``launched`` (false where the entry has
    nothing to launch)."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else
              a.ctypes.data if isinstance(a, np.ndarray) else a for a in args]
    err = function(source, entry, signature + "P")(*c_args, stream_of(like))
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    if counter is not None and launched:
        counter.launches += 1


def _shape_text(shape) -> str:
    return "(" + ", ".join("*" if w is None else str(w) for w in shape) + ")"


def require(fn: str, arg: str, t, *, like, dtype=torch.float32, shape=None,
            align16: bool = False, contiguous: bool = True) -> None:
    """Refuses, with a ValueError, a tensor that ``fn``'s C entry cannot
    take: ``t`` must be a ``dtype`` tensor on ``like``'s device, contiguous
    unless ``contiguous`` is false (the entry takes its strides), of
    ``shape`` where one is given (None: any size on that axis) and, where
    ``align16``, 16-byte aligned, for a kernel that reads it as float4.
    Reads metadata only: it waits for and copies nothing."""
    # a shape without wildcards compares whole (the common case, and the
    # fast one: every kernel launch runs these checks on the host)
    fits = shape is None or t.shape == shape or (t.dim() == len(shape) and all(
        w is None or w == s for w, s in zip(shape, t.shape)))
    if (t.dtype != dtype or t.device != like.device or not fits
            or (contiguous and not t.is_contiguous())):
        want = "contiguous " if contiguous else ""
        want += f"{dtype}" + ("" if shape is None else f" {_shape_text(shape)}")
        got = f"{tuple(t.shape)} {t.dtype}"
        got += "" if t.is_contiguous() else " non-contiguous"
        raise ValueError(f"{fn}: {arg} must be a {want} tensor on "
                         f"{like.device}, got {got} on {t.device}")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{fn}: {arg} must be 16-byte aligned (the kernel "
                         "reads it as float4)")
