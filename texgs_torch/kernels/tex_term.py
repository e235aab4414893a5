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

import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import grid_shape
from texgs_torch.kernels.cubemap import sample_cubemap
from texgs_torch.kernels.tile_raster import PIX, tiles_to_image
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


def _check_args(name: str, mlist, texture, height: int, width: int) -> int:
    """Refuses kernel B's (or B''s) arguments where its C entry cannot take
    them; returns the grid width in tiles."""
    gy, gx = grid_shape(height, width)
    _build.require(name, "mlist", mlist, like=mlist,
                   shape=(gy * gx, PIX, None, 4), align16=True)
    if mlist.shape[2] < 1:
        raise ValueError(f"{name}: the M-lists must hold m >= 1 slots")
    res = texture.shape[1] if texture.dim() == 4 else 0
    _build.require(name, "texture", texture, like=mlist,
                   shape=(6, res, res, 3))
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
    gx = _check_args("tex_term", mlist, texture, height, width)
    n_tiles, _, m, _ = mlist.shape
    out = torch.empty((3, height, width), device=mlist.device)
    # the C entry launches nothing for an empty grid
    _build.launch("tex_term", "tex_term_forward", "PPiiiiiiiP", mlist,
                  texture, texture.shape[1], FILTER_MODES[filter_mode],
                  n_tiles, m, gx, height, width, out, like=mlist,
                  counter=tex_term, launched=n_tiles > 0)
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
    kernel.  The two launches count as one."""
    if filter_mode not in FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if mlist.device.type == "cpu":
        return mlist_tex_term_vjp(mlist, texture, g_img, height, width,
                                  filter_mode)
    name = "tex_term_backward"
    gx = _check_args(name, mlist, texture, height, width)
    _build.require(name, "g_img", g_img, like=mlist, shape=(3, height, width))
    n_tiles, _, m, _ = mlist.shape
    d_mlist = torch.empty_like(mlist)
    d_texture4 = torch.zeros((*texture.shape[:3], 4), device=mlist.device)
    d_texture = torch.empty_like(texture)
    _build.launch("tex_term_bwd", "tex_term_backward", "PPiiiiiiiPPP", mlist,
                  texture, texture.shape[1], FILTER_MODES[filter_mode],
                  n_tiles, m, gx, height, width, g_img, d_mlist, d_texture4,
                  like=mlist)
    _build.launch("tex_term_bwd", "tex_term_pack", "PiP", d_texture4,
                  d_texture4.numel() // 4, d_texture, like=mlist,
                  counter=tex_term_backward, launched=n_tiles > 0)
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
