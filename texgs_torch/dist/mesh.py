"""Process groups and device meshes (port of texgs/dist/mesh.py).

texgs builds a ``jax.sharding.Mesh`` over the chips and runs its steps
under ``shard_map``; the port runs one process a rank and builds a
``torch.distributed`` ``DeviceMesh`` with texgs's axis names (``data``,
``tile``, ``gauss``).  Every rank holds the whole model; the steps of
``texgs_torch.dist.sharded`` split the render work over the mesh's axes
and reduce the gradients with the collectives of ``dist.collectives``.

The backend follows the device: NCCL for CUDA, gloo for the CPU, unless
the caller names one.  NCCL refuses two ranks on one card, so ranks that
share a card run gloo over CUDA tensors, named explicitly by their caller
(``dist.dryrun``); gloo then carries each collective through host memory.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks
TIMEOUT_S = 600


def initialize_dist(backend: Optional[str] = None, device="cuda",
                    init_method: Optional[str] = None,
                    world_size: Optional[int] = None,
                    rank: Optional[int] = None) -> torch.device:
    """``init_process_group`` from ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT`` (``env://``), or from ``init_method`` (for example
    ``tcp://localhost:<port>``), ``world_size`` and ``rank``.  backend:
    ``nccl`` for a CUDA device and ``gloo`` for the CPU unless named.
    Returns this rank's device, made current: ``device`` as given, or for
    a bare ``cuda`` the card ``rank % cards`` (every rank on card 0 of a
    one-card machine)."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_dist: CUDA was asked for and no GPU "
                           "is visible; pass device='cpu' to run on the CPU")
    if rank is None:
        rank = (dist.get_rank() if dist.is_initialized()
                else int(os.environ.get("RANK", 0)))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
            # NCCL binds the rank to its card; gloo carries CUDA tensors
            # through the host and takes no device
            device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device="cuda"):
    """A ``DeviceMesh`` over every rank of the process group, axes named as
    texgs names them.  ``shape`` gives each axis's size (default: every
    rank on the first axis, 1 on the others)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not "
                         f"hold the {n} ranks")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axis_names)


def transport(mesh) -> str:
    """How the mesh's collectives travel, for the log: the backend, and
    for gloo over CUDA tensors, the host copies it takes."""
    backend = dist.get_backend()
    kind = mesh.device_type
    if backend == "gloo" and kind == "cuda":
        return ("gloo over CUDA tensors: every collective copies its tensors "
                "to the host and back (ranks that share a card)")
    return f"{backend} over {kind} tensors"
