"""Kernel B and its backward B': the stage-3 texture term from the M-lists,
differentiable.

Replaces the TPU kernel ``textile_apply`` of
texgs/kernels/pallas_textile.py:774 (forward ``_fwd_kernel``, :568;
backward ``_bwd_kernel``, :626; entry ``tex_term_textile``, :988).  The
CUDA kernels are csrc/tex_term.cu and csrc/tex_term_bwd.cu.  They compute
the exact ``mlist_tex_term`` of texgs/kernels/uvtex_raster.py:385, ported
below as the forward's plain version, and its VJP (``mlist_tex_term_vjp``,
autograd through it); the TPU kernel's windows, mip atlas, catch-all pack
and miss correction approximate that function and are not ported.

``tex_term`` is differentiable in the M-lists and the texture; its
backward calls ``tex_term_backward``.  Both run the plain version only for
tensors on the CPU; for CUDA tensors they launch their kernel or raise.
Each launch adds one to ``tex_term.launches`` or
``tex_term_backward.launches``.

Dead slots (w = 0): the backward gives them a zero uv cotangent and a zero
w cotangent.  The plain version's w cotangent there is C0 <g, tex> at the
zero direction; kernel A' never reads it (tests/test_textile.py:78-86).
"""

from __future__ import annotations

import ctypes

import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import grid_shape
from texgs_torch.kernels.cubemap import sample_cubemap
from texgs_torch.kernels.tile_raster import tiles_to_image
from texgs_torch.utils.sh import C0
from texgs_torch.utils.spans import spanned

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


def mlist_tex_term_vjp(mlist: torch.Tensor, texture: torch.Tensor,
                       g_img: torch.Tensor, height: int, width: int,
                       filter_mode: str = "bilinear"):
    """Plain version of kernel B': autograd through ``mlist_tex_term``.
    Returns (d_mlist (T, PIX, m, 4), d_texture (6, R, R, 3))."""
    with torch.enable_grad():
        ml = mlist.detach().requires_grad_(True)
        tex = texture.detach().requires_grad_(True)
        out = mlist_tex_term(ml, tex, height, width, filter_mode)
        return torch.autograd.grad(out, (ml, tex), g_img)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_args(name: str, mlist, texture, height: int, width: int,
                filter_mode: str) -> int:
    """Validates kernel B's (or B''s) arguments on a CUDA device; returns
    the grid width in tiles."""
    if mlist.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {mlist.device}")
    gy, gx = grid_shape(height, width)
    n_tiles, pix, m, four = mlist.shape
    if (n_tiles, pix, four) != (gy * gx, 256, 4) or m < 1:
        raise ValueError(f"{name}: M-lists must be ({gy * gx}, 256, m, 4), "
                         f"got {tuple(mlist.shape)}")
    res = texture.shape[1]
    if texture.shape != (6, res, res, 3):
        raise ValueError(f"{name}: texture must be (6, R, R, 3), got "
                         f"{tuple(texture.shape)}")
    for arg, t in (("mlist", mlist), ("texture", texture)):
        if (t.device != mlist.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be a contiguous float32 "
                             f"tensor on {mlist.device}")
    if mlist.data_ptr() % 16:
        raise ValueError(f"{name}: the M-lists must be 16-byte aligned "
                         "(the kernel reads each slot as one float4)")
    return gx


@spanned("kernel.tex_term")
def tex_term_forward(mlist: torch.Tensor, texture: torch.Tensor, height: int,
                     width: int, filter_mode: str = "bilinear") -> torch.Tensor:
    """Kernel B without autograd: (T, PIX, m, 4) M-lists and a (6, R, R, 3)
    cubemap -> (3, H, W) texture term.  CPU tensors take the plain version;
    CUDA tensors launch csrc/tex_term.cu."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if mlist.device.type == "cpu":
        return mlist_tex_term(mlist, texture, height, width, filter_mode)
    gx = _check_args("tex_term", mlist, texture, height, width, filter_mode)
    n_tiles, _, m, _ = mlist.shape
    out = torch.empty((3, height, width), device=mlist.device)
    p = _build.ptr
    err = _build.function("tex_term", "tex_term_forward",
                          [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P])(
        p(mlist), p(texture), texture.shape[1], FILTER_MODES[filter_mode],
        n_tiles, m, gx, height, width, p(out), _build.stream_of(mlist))
    if err:
        raise RuntimeError(f"tex_term_forward failed: CUDA error {err}")
    if n_tiles > 0:  # the C entry launches nothing for an empty grid
        tex_term.launches += 1
    return out


@spanned("kernel.tex_term_bwd")
def tex_term_backward(mlist: torch.Tensor, texture: torch.Tensor,
                      g_img: torch.Tensor, height: int, width: int,
                      filter_mode: str = "bilinear"):
    """Kernel B': the VJP of the texture term into (d_mlist, d_texture) for
    the (3, H, W) cotangent ``g_img``.  CPU tensors take the plain version
    (``mlist_tex_term_vjp``); CUDA tensors launch csrc/tex_term_bwd.cu,
    which adds the texture gradient into texels padded to 16 bytes (one
    vector atomic a texel) and packs them to (6, R, R, 3) in a second
    kernel."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if mlist.device.type == "cpu":
        return mlist_tex_term_vjp(mlist, texture, g_img, height, width,
                                  filter_mode)
    gx = _check_args("tex_term_backward", mlist, texture, height, width,
                     filter_mode)
    if (g_img.shape != (3, height, width) or g_img.device != mlist.device
            or g_img.dtype != torch.float32 or not g_img.is_contiguous()):
        raise ValueError(f"tex_term_backward: g_img must be a contiguous "
                         f"float32 (3, {height}, {width}) tensor on "
                         f"{mlist.device}")
    n_tiles, _, m, _ = mlist.shape
    d_mlist = torch.empty_like(mlist)
    d_texture4 = torch.zeros((*texture.shape[:3], 4), device=mlist.device)
    d_texture = torch.empty_like(texture)
    p, stream = _build.ptr, _build.stream_of(mlist)
    err = _build.function("tex_term_bwd", "tex_term_backward",
                          [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])(
        p(mlist), p(texture), texture.shape[1], FILTER_MODES[filter_mode],
        n_tiles, m, gx, height, width, p(g_img), p(d_mlist), p(d_texture4),
        stream)
    if not err:
        err = _build.function("tex_term_bwd", "tex_term_pack",
                              [_P, _I, _P, _P])(
            p(d_texture4), d_texture4.numel() // 4, p(d_texture), stream)
    if err:
        raise RuntimeError(f"tex_term_backward failed: CUDA error {err}")
    if n_tiles > 0:
        tex_term_backward.launches += 1
    return d_mlist, d_texture


class _TexTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mlist, texture, height, width, filter_mode):
        ctx.save_for_backward(mlist, texture)
        ctx.args = (height, width, filter_mode)
        return tex_term_forward(mlist, texture, height, width, filter_mode)

    @staticmethod
    def backward(ctx, g_img):
        mlist, texture = ctx.saved_tensors
        d_mlist, d_texture = tex_term_backward(mlist, texture,
                                               g_img.contiguous(), *ctx.args)
        return d_mlist, d_texture, None, None, None


def tex_term(mlist: torch.Tensor, texture: torch.Tensor, height: int,
             width: int, filter_mode: str = "bilinear") -> torch.Tensor:
    """(T, PIX, m, 4) M-lists and a (6, R, R, 3) cubemap -> (3, H, W)
    texture term, differentiable in both.  The forward is one launch of
    kernel B on CUDA tensors, the backward one of kernel B'."""
    return _TexTerm.apply(mlist, texture, height, width, filter_mode)


tex_term.launches = 0
tex_term_backward.launches = 0
