"""Kernel B: the stage-3 texture term from the M-lists.

Replaces the TPU kernel ``textile_apply`` of
texgs/kernels/pallas_textile.py:774 (forward ``_fwd_kernel``, :568; entry
``tex_term_textile``, :988).  The CUDA kernel is csrc/tex_term.cu.  It
computes the exact ``mlist_tex_term`` of texgs/kernels/uvtex_raster.py:385,
ported below as its plain version; the TPU kernel's windows, mip atlas,
catch-all pack and miss correction approximate that function and are not
ported.

``tex_term`` runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Each launch adds one to
``tex_term.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import grid_shape
from texgs_torch.kernels.cubemap import sample_cubemap
from texgs_torch.kernels.tile_raster import tiles_to_image
from texgs_torch.utils.sh import C0

FILTER_MODES = {"bilinear": 0, "bilinear_clamp": 1, "nearest": 2}
TILE_BLOCK = 128  # tiles the plain version samples at a time


def mlist_tex_term(mlist: torch.Tensor, texture: torch.Tensor,
                   height: int, width: int,
                   filter_mode: str = "bilinear") -> torch.Tensor:
    """Plain version: (T, PIX, m, 4) M-lists -> (3, H, W) texture term
    C0 * sum_m w_m * sample_cubemap(texture, uv_m).  Tiles go in blocks of
    TILE_BLOCK to bound the memory of the tap intermediates."""
    t, pix, m, _ = mlist.shape
    terms = []
    for i in range(0, t, TILE_BLOCK):
        blk = mlist[i:i + TILE_BLOCK]
        tex = sample_cubemap(texture, blk[..., 1:4].reshape(-1, 3),
                             filter_mode).reshape(blk.shape[0], pix, m, 3)
        terms.append(C0 * (blk[..., 0:1] * tex).sum(dim=2))
    return tiles_to_image(torch.cat(terms), height, width)


def _lib() -> ctypes.CDLL:
    lib = _build.load("tex_term")
    fn = lib.tex_term_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def tex_term(mlist: torch.Tensor, texture: torch.Tensor, height: int,
             width: int, filter_mode: str = "bilinear") -> torch.Tensor:
    """(T, PIX, m, 4) M-lists and a (6, R, R, 3) cubemap -> (3, H, W)
    texture term.  CPU tensors take the plain version; CUDA tensors launch
    csrc/tex_term.cu."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if mlist.device.type == "cpu":
        return mlist_tex_term(mlist, texture, height, width, filter_mode)
    if mlist.device.type != "cuda":
        raise ValueError(f"tex_term: unsupported device {mlist.device}")
    gy, gx = grid_shape(height, width)
    n_tiles, pix, m, four = mlist.shape
    if (n_tiles, pix, four) != (gy * gx, 256, 4) or m < 1:
        raise ValueError(f"tex_term: M-lists must be ({gy * gx}, 256, m, 4), "
                         f"got {tuple(mlist.shape)}")
    res = texture.shape[1]
    if texture.shape != (6, res, res, 3):
        raise ValueError(f"tex_term: texture must be (6, R, R, 3), got "
                         f"{tuple(texture.shape)}")
    for name, t in (("mlist", mlist), ("texture", texture)):
        if (t.device != mlist.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"tex_term: {name} must be a contiguous float32 "
                             f"tensor on {mlist.device}")
    if mlist.data_ptr() % 16:
        raise ValueError("tex_term: the M-lists must be 16-byte aligned "
                         "(the kernel reads each slot as one float4)")
    out = torch.empty((3, height, width), device=mlist.device)
    p = _build.ptr
    err = _lib().tex_term_forward(
        p(mlist), p(texture), res, FILTER_MODES[filter_mode], n_tiles, m,
        gx, height, width, p(out), _build.stream_of(mlist))
    if err:
        raise RuntimeError(f"tex_term_forward failed: CUDA error {err}")
    tex_term.launches += 1
    return out


tex_term.launches = 0
