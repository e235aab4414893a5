"""Kernels K5' and K5'': the fused multiresolution hash encode and its VJP.

One CUDA kernel (csrc/hash_encode.cu) computes texgs's ``apply_hashgrid``
(texgs/nets/hashgrid.py:60-100, the ``xla`` branch's semantics, which the
Pallas gather of texgs/nets/pallas_hashgrid.py:63 reproduces) whole: the
points' grid cells, the 8 corners' spatial hash, the trilinear weights,
the table rows and their weighted sum.  Its backward (csrc/hash_encode_bwd.cu)
recomputes the corners, adds w * g into the table gradient and writes the
points' gradient.

``encode_plain`` is the plain PyTorch version of the forward: the corner
indices and weights of ``indices_and_weights``, the gather of
``hash_gather.gather_plain`` and the weighted sum; differentiable in the
table and the points under autograd.  ``encode_backward_plain`` is the plain
version of the backward: the formula the kernel computes, in tensor
operations, not autograd.

``hash_encode`` is differentiable in the table and the points.  For tensors
on the CPU it runs the two plain versions; for CUDA tensors it launches the
kernels or raises.  Each forward launch adds one to ``hash_encode.launches``,
each backward launch one to ``hash_encode_backward.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from texgs_torch import _build
from texgs_torch.nets.hash_gather import _gather_backward, gather_plain
from texgs_torch.utils.spans import spanned

PRIMES = (1, 2654435761, 805459861)
BASE_RESOLUTION = 16
PER_LEVEL_SCALE = 1.447
U32 = 0xFFFFFFFF
CORNERS = 8
MAX_LEVELS = 32   # the levels of one point share a warp in the backward
MAX_FEATURES = 8


def level_resolution(level: int) -> int:
    """floor(16 * 1.447^level), in Python floats as texgs computes it."""
    return int(math.floor(BASE_RESOLUTION * PER_LEVEL_SCALE ** level))


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 a, as uint32 arithmetic wraps.  The
    prime is split in 16-bit halves so no int64 product overflows."""
    a = a & U32
    return (a * (p & 0xFFFF) + (((a * (p >> 16)) & 0xFFFF) << 16)) & U32


def _hash(ix, iy, iz, table_size: int) -> torch.Tensor:
    """tcnn's spatial hash with uint32 wrap-around, computed in int64."""
    h = _mul_u32(ix, PRIMES[0]) ^ _mul_u32(iy, PRIMES[1]) \
        ^ _mul_u32(iz, PRIMES[2])
    return (h % table_size).to(torch.int32)


def _cells(x: torch.Tensor, n_levels: int):
    """Per level, the grid cell (int64 (N, 3)) and the fraction inside it
    (f32 (N, 3)) of the points x (N, 3) at resolution level_resolution."""
    for level in range(n_levels):
        pos = x * level_resolution(level)
        ipos = torch.floor(pos).to(torch.int32)
        yield ipos.to(torch.int64), pos - ipos


def _corner_bits(corner: int):
    return corner & 1, (corner >> 1) & 1, (corner >> 2) & 1


def indices_and_weights(x: torch.Tensor, n_levels: int, table_size: int):
    """Corner hash indices (L * 8, N) int32 and trilinear weights (L * 8, N)
    of the points x (N, 3) in [0, 1].  The weights are differentiable in x;
    the indices are integers."""
    idxs, ws = [], []
    for ip, frac in _cells(x, n_levels):
        for corner in range(CORNERS):
            dx, dy, dz = _corner_bits(corner)
            idxs.append(_hash(ip[:, 0] + dx, ip[:, 1] + dy, ip[:, 2] + dz,
                              table_size))
            ws.append((frac[:, 0] if dx else 1 - frac[:, 0])
                      * (frac[:, 1] if dy else 1 - frac[:, 1])
                      * (frac[:, 2] if dz else 1 - frac[:, 2]))
    return torch.stack(idxs), torch.stack(ws)


def encode_plain(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the encode: (L, T, F) tables and points x (N, 3) in
    [0, 1] -> (N, L * F) features, level-major."""
    n_levels, table_size, n_feat = table.shape
    n = x.shape[0]
    idx, w = indices_and_weights(x, n_levels, table_size)
    gathered = gather_plain(table, idx)                      # (L*8, F, N)
    feats = (gathered * w[:, None, :]).reshape(
        n_levels, CORNERS, n_feat, n).sum(dim=1)              # (L, F, N)
    return feats.permute(2, 0, 1).reshape(n, n_levels * n_feat)


def encode_backward_plain(table: torch.Tensor, x: torch.Tensor,
                          g: torch.Tensor, need_x: bool = True):
    """Plain version of the encode's VJP for the cotangent g (N, L * F):
    (d_table (L, T, F), d_x (N, 3) or None).  The formula the kernel
    computes, written out:

      d_table[l, h_c] += w_c g[l]                 for each corner c,
      d_x_a = sum_l res_l sum_c (g[l] . table[l, h_c]) dw_c / dfrac_a,

    where w_c is the product of the factors frac_a (corner bit a set) or
    1 - frac_a, so dw_c / dfrac_a is +-(the product of the other two).
    floor carries no gradient, as under JAX autodiff."""
    n_levels, table_size, n_feat = table.shape
    n = x.shape[0]
    with torch.no_grad():
        idx, w = indices_and_weights(x, n_levels, table_size)
        g_l = g.reshape(n, n_levels, n_feat).permute(1, 2, 0)   # (L, F, N)
        g_rows = (w.view(n_levels, CORNERS, 1, n)
                  * g_l[:, None]).reshape(n_levels * CORNERS, n_feat, n)
        d_table = _gather_backward(table.shape, idx, g_rows)
        if not need_x:
            return d_table, None
        rows = gather_plain(table, idx).reshape(n_levels, CORNERS, n_feat, n)
        s = (rows * g_l[:, None]).sum(dim=2)                     # (L, 8, N)
        d_x = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
        for level, (_, frac) in enumerate(_cells(x, n_levels)):
            d_frac = torch.zeros_like(frac)
            for corner in range(CORNERS):
                bits = _corner_bits(corner)
                f = [frac[:, a] if bits[a] else 1 - frac[:, a]
                     for a in range(3)]
                others = (f[1] * f[2], f[0] * f[2], f[0] * f[1])
                for a in range(3):
                    term = s[level, corner] * others[a]
                    d_frac[:, a] += term if bits[a] else -term
            d_x += level_resolution(level) * d_frac
    return d_table, d_x


def _check_args(name: str, table, x, g=None):
    """Validates the arguments of the encode kernels on a CUDA device."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dim() != 3 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: table must be (L, T, F) and x (N, 3), got "
                         f"{tuple(table.shape)} and {tuple(x.shape)}")
    n_levels, table_size, n_feat = table.shape
    if not (1 <= n_levels <= MAX_LEVELS and 1 <= n_feat <= MAX_FEATURES
            and 1 <= table_size < 2 ** 31
            and n_levels * table_size * n_feat < 2 ** 31):
        raise ValueError(f"{name}: the kernels take 1..{MAX_LEVELS} levels "
                         f"of 1..{MAX_FEATURES} features, got "
                         f"{tuple(table.shape)}")
    tensors = [("table", table), ("x", x)] + ([("g", g)] if g is not None
                                             else [])
    for arg, t in tensors:
        if t.device != table.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous float32 "
                             f"tensor on {table.device}")
    if g is not None and tuple(g.shape) != (x.shape[0], n_levels * n_feat):
        raise ValueError(f"{name}: g must be ({x.shape[0]}, "
                         f"{n_levels * n_feat}), got {tuple(g.shape)}")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned (the "
                         "kernels read a row of 4 features as one float4)")


def _resolutions(n_levels: int):
    """Each level's grid resolution as the C entries take them: host ints,
    computed here in Python floats (never with the device's powf)."""
    return (ctypes.c_int * n_levels)(*(level_resolution(lv)
                                       for lv in range(n_levels)))


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
_BWD_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]


@spanned("kernel.hash_encode")
def hash_encode_forward(table: torch.Tensor, x: torch.Tensor,
                        corners: bool = False):
    """Kernel K5' without autograd: (N, L * F) features of the points x
    (N, 3).  With ``corners``, also the corner indices (L * 8, N) int32 and
    weights (L * 8, N) the kernel computed (``indices_and_weights``'
    layout), for checks.  CPU tensors take the plain version; CUDA tensors
    launch csrc/hash_encode.cu."""
    if table.device.type == "cpu":
        out = encode_plain(table, x)
        if corners:
            return (out, *indices_and_weights(x, *table.shape[:2]))
        return out
    _check_args("hash_encode", table, x)
    n_levels, table_size, n_feat = table.shape
    n = x.shape[0]
    out = torch.empty((n, n_levels * n_feat), device=table.device)
    idx = w = None
    if corners:
        idx = torch.empty((n_levels * CORNERS, n), dtype=torch.int32,
                          device=table.device)
        w = torch.empty((n_levels * CORNERS, n), device=table.device)
    p = _build.ptr
    err = _build.function("hash_encode", "hash_encode_forward", _FWD_ARGS)(
        p(table), p(x), _resolutions(n_levels), n_levels, table_size, n_feat,
        n, p(out), p(idx) if corners else None, p(w) if corners else None,
        _build.stream_of(table))
    if err:
        raise RuntimeError(f"hash_encode_forward failed: CUDA error {err}")
    if n > 0:  # the C entry launches nothing for an empty query
        hash_encode.launches += 1
    return (out, idx, w) if corners else out


@spanned("kernel.hash_encode_bwd")
def hash_encode_backward(table: torch.Tensor, x: torch.Tensor,
                         g: torch.Tensor, need_x: bool = True):
    """Kernel K5'': the encode's VJP for the cotangent g (N, L * F) ->
    (d_table (L, T, F), d_x (N, 3), or None without ``need_x``).  CPU
    tensors take the plain version (``encode_backward_plain``); CUDA
    tensors launch csrc/hash_encode_bwd.cu."""
    if table.device.type == "cpu":
        return encode_backward_plain(table, x, g, need_x)
    _check_args("hash_encode_backward", table, x, g)
    if g.data_ptr() % 16:  # the kernel reads g a row at a time, as the table
        g = g.clone()
    n_levels, table_size, n_feat = table.shape
    n = x.shape[0]
    d_table = torch.zeros_like(table)
    d_x = torch.empty((n, 3), device=table.device) if need_x else None
    p = _build.ptr
    err = _build.function("hash_encode_bwd", "hash_encode_backward",
                          _BWD_ARGS)(
        p(table), p(x), p(g), _resolutions(n_levels), n_levels, table_size,
        n_feat, n, p(d_table), p(d_x) if need_x else None,
        _build.stream_of(table))
    if err:
        raise RuntimeError(f"hash_encode_backward failed: CUDA error {err}")
    if n > 0:
        hash_encode_backward.launches += 1
    return d_table, d_x


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x):
        ctx.save_for_backward(table, x)
        return hash_encode_forward(table, x)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        d_table, d_x = hash_encode_backward(table, x, g.contiguous(),
                                            ctx.needs_input_grad[1])
        return d_table, d_x


def hash_encode(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L, T, F) f32 tables and points x (N, 3) in [0, 1] -> (N, L * F)
    encoded features, differentiable in the table and the points.  The
    forward is one launch of kernel K5' on CUDA tensors, the backward one
    of K5'' (after zeroing the table gradient)."""
    return _HashEncode.apply(table, x)


hash_encode.launches = 0
hash_encode_backward.launches = 0
