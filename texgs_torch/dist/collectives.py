"""The collectives of the sharded steps, over the named axes of a
``DeviceMesh`` (texgs's ``psum``, ``pmean``, ``pmax`` and ``all_gather``
under ``shard_map``).

* ``psum_``/``pmean_``/``pmax_``: ``all_reduce`` in place over an axis's
  group (skipped for an axis of one rank); pmean divides by the axis size.
* ``all_gather``: differentiable.  Its backward sums the cotangents over
  the group and keeps the rank's own slice, which is JAX's transpose of
  ``all_gather`` (a ``psum_scatter``): with a loss replicated on every
  rank of the axis, each slice's cotangent arrives n times, and the
  caller's ``grad_scale(x, 1 / n)`` before the gather makes the later
  parameter-gradient sum count it once (texgs sharded.py:73-91).
* ``grad_scale``: keeps the value, scales the gradient (texgs
  sharded.py:59-70).

Gloo carries CUDA tensors through host copies: each collective here copies
its tensor to the CPU and back when its group's backend is gloo and the
tensor is on a card (ranks that share one card, where NCCL refuses two
ranks).  That is the transport only; the computation stays on the card.
``TRAFFIC`` counts the bytes each rank hands to each kind of collective,
from the tensors' shapes.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# bytes this rank handed to each kind of collective (all_gather: the
# gathered result), counted from shapes
TRAFFIC = {"all_gather": 0, "all_reduce": 0}


def axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: Optional[str]) -> int:
    """This rank's coordinate along ``axis`` (texgs's ``axis_index``)."""
    if axis is None:
        return 0
    return mesh.get_local_rank(axis)


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, op, group) -> None:
    if _through_host(t, group):
        host = t.cpu()  # gloo: the host carries the CUDA tensor
        dist.all_reduce(host, op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op, group=group)


def psum_(t: torch.Tensor, mesh, axes: Iterable[Optional[str]]) -> torch.Tensor:
    """Sum ``t`` (contiguous) over each named axis, in place."""
    for axis in axes:
        if axis_size(mesh, axis) > 1:
            TRAFFIC["all_reduce"] += t.numel() * t.element_size()
            _all_reduce(t, dist.ReduceOp.SUM, mesh.get_group(axis))
    return t


def pmean_(t: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n > 1:
        psum_(t, mesh, [axis]).div_(n)
    return t


def pmax_(t: torch.Tensor, mesh, axes: Iterable[Optional[str]]) -> torch.Tensor:
    for axis in axes:
        if axis_size(mesh, axis) > 1:
            TRAFFIC["all_reduce"] += t.numel() * t.element_size()
            _all_reduce(t, dist.ReduceOp.MAX, mesh.get_group(axis))
    return t


def gather_stack(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` along ``axis``, in axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x[None]
    group = mesh.get_group(axis)
    src = x.detach().contiguous()
    host = _through_host(src, group)
    if host:
        src = src.cpu()  # gloo: the host carries the CUDA tensor
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    TRAFFIC["all_gather"] += n * src.numel() * src.element_size()
    out = torch.stack(parts)
    return out.to(x.device) if host else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return gather_stack(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        g = psum_(g.contiguous().clone(), ctx.mesh, [ctx.axis])
        return g[axis_index(ctx.mesh, ctx.axis)], None, None


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Differentiable ``gather_stack``: the backward sums the cotangents
    over ``axis`` and keeps this rank's slice."""
    return _AllGather.apply(x, mesh, axis)


def grad_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """x unchanged in value, its gradient scaled by s.  A loss term that
    touches parameters directly is computed on every rank of the render
    axes; scaled by 1/n_repl, the sum over those axes counts it once."""
    if s == 1.0:
        return x
    return x * s + x.detach() * (1.0 - s)


def flat_grads(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves' ``.grad`` (zeros where a leaf has none) in one flat
    contiguous buffer, so a step reduces them in one collective."""
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in leaves])


def set_grads(leaves: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    """Each leaf's ``.grad`` from its span of ``flat``."""
    i = 0
    for p in leaves:
        p.grad = flat[i:i + p.numel()].view_as(p).clone()
        i += p.numel()


@torch.no_grad()
def replica_divergence(tensors: Sequence[torch.Tensor]) -> float:
    """max over ranks and elements of |t - rank 0's t|: 0 while the
    replicas of the model agree bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if dist.get_world_size() == 1:
        return 0.0
    ref = flat.clone()
    host = ref.is_cuda and dist.get_backend() == "gloo"
    if host:
        ref = ref.cpu()  # gloo: the host carries the CUDA tensor
    dist.broadcast(ref, src=0)
    diff = (flat - ref.to(flat.device)).abs().max().reshape(1)
    _all_reduce(diff, dist.ReduceOp.MAX, None)
    return float(diff)
