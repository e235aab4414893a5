"""Gaussian projection: EWA splatting (port of texgs/kernels/project.py).

Frustum cull, perspective projection of centers, first-order projection of
the 3D covariance to a 2D screen covariance with the +0.3 px low-pass
dilation, conic + radius, and the flattened-Gaussian shortest-axis world
normal.

``project_plain`` is the plain version: batched elementwise tensor code in
texgs's channel form, differentiable by autograd.  ``project_gaussians``
runs it for CPU tensors; for CUDA tensors it launches kernel P
(csrc/project.cu, one launch a render) and, where an input needs a
gradient, its VJP P' (csrc/project_bwd.cu, one launch a backward), or
raises.  The camera reaches the kernels by value from its host arrays, so
the projection copies nothing to the device and waits for nothing.  Each
launch adds one to ``project_gaussians.launches`` or
``project_gaussians_backward.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from texgs_torch import _build
from texgs_torch.utils.sh import eval_sh
from texgs_torch.utils.spans import spanned
from texgs_torch.utils.transforms import (build_covariance_packed,
                                          rotation_channels, strip_symmetric)

# Gaussians closer than this view-space depth are culled (3DGS convention).
NEAR_CULL = 0.2
# Low-pass filter added to the diagonal of the 2D covariance (pixels^2).
COV2D_DILATION = 0.3


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coordinates of projected centers
    depths: torch.Tensor    # (N,) view-space z
    conics: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c) packed
    radii: torch.Tensor     # (N,) int32 screen-space radius (0 = culled)
    colors: Optional[torch.Tensor]  # (N, 3) per-Gaussian RGB, or None
    # where the caller supplies them later (stage 3: rasterize_uvtex)
    opacities: torch.Tensor  # (N,) activated opacity
    normals: torch.Tensor   # (N, 3) world-space unit normal, camera-facing


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(xyz, full_proj, width: int, height: int,
                   ndc_offset=None):
    """World points -> (pixel xy, clip w), row-vector convention.

    ``ndc_offset`` is an optional (N, 2) zeros tensor added to the NDC
    means: its gradient is the screen-space positional gradient the
    densifier reads, in texgs's NDC units (pixel gradient * [W/2, H/2])."""
    ones = torch.ones_like(xyz[:, :1])
    p_hom = torch.cat([xyz, ones], dim=-1) @ full_proj  # (N, 4)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc_xy = p_hom[:, :2] * p_w[:, None]
    if ndc_offset is not None:
        ndc_xy = ndc_xy + ndc_offset
    means2d = torch.stack([ndc2pix(ndc_xy[:, 0], width),
                           ndc2pix(ndc_xy[:, 1], height)], dim=-1)
    return means2d, p_hom[:, 3]


def compute_cov2d(xyz, cov3d, world_view, tanfovx: float, tanfovy: float,
                  focal_x: float, focal_y: float) -> torch.Tensor:
    """EWA projection of the packed (N, 6) 3D covariance to the packed
    (N, 3) screen covariance (a, b, c), +0.3 dilation applied.

    T = J @ W rows are expanded as T0 = a0 W0 + c0 W2, T1 = b1 W1 + c1 W2,
    so cov2d needs only the six scalars Wi Sigma Wj^T: one (N, 6) x (6, 6)
    contraction plus elementwise math."""
    ones = torch.ones_like(xyz[:, :1])
    t = (torch.cat([xyz, ones], dim=-1) @ world_view)[:, :3]

    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    a0 = focal_x * inv_z
    c0 = -focal_x * txtz * inv_z2
    b1 = focal_y * inv_z
    c1 = -focal_y * tytz * inv_z2

    W = world_view[:3, :3].T  # world->view rotation, column form
    rows = []
    for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]:
        wi, wj = W[i], W[j]
        rows.append(torch.stack([
            wi[0] * wj[0],
            wi[0] * wj[1] + wi[1] * wj[0],
            wi[0] * wj[2] + wi[2] * wj[0],
            wi[1] * wj[1],
            wi[1] * wj[2] + wi[2] * wj[1],
            wi[2] * wj[2],
        ]))
    quad_mat = torch.stack(rows, dim=1)       # (6 channels, 6 pairs)
    q = cov3d @ quad_mat                      # (N, 6) scalars Wi S Wj
    s00, s01, s02, s11, s12, s22 = q.unbind(dim=1)

    a = a0 * a0 * s00 + 2 * a0 * c0 * s02 + c0 * c0 * s22 + COV2D_DILATION
    b = a0 * b1 * s01 + a0 * c1 * s02 + c0 * b1 * s12 + c0 * c1 * s22
    c = b1 * b1 * s11 + 2 * b1 * c1 * s12 + c1 * c1 * s22 + COV2D_DILATION
    return torch.stack([a, b, c], dim=-1)


def flat_normals(scaling, rotation, xyz, campos) -> torch.Tensor:
    """Shortest-axis normal of each (flattened) Gaussian, flipped to face
    the camera."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    idx = torch.argmin(scaling, dim=-1)
    is0 = idx == 0
    is1 = idx == 1
    nx = torch.where(is0, r00, torch.where(is1, r01, r02))
    ny = torch.where(is0, r10, torch.where(is1, r11, r12))
    nz = torch.where(is0, r20, torch.where(is1, r21, r22))
    n = torch.stack([nx, ny, nz], dim=-1)
    to_cam = campos[None, :] - xyz
    sign = torch.sign((n * to_cam).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return n * sign


def project_plain(xyz, scaling, rotation, opacity, colors,
                  world_view, full_proj, campos,
                  width: int, height: int, tanfovx: float, tanfovy: float,
                  scaling_modifier: float = 1.0,
                  cov3d_precomp=None, ndc_offset=None) -> ProjectedGaussians:
    """Cull + project + conic/radius + normals: the plain version of kernel
    P, on any device.

    world_view/full_proj/campos are tensors on the Gaussians' device.
    Culled Gaussians get radius 0 and opacity 0.  ``cov3d_precomp``: the
    world covariances, (N, 3, 3) or packed (N, 6) upper triangle (xx, xy,
    xz, yy, yz, zz), in place of the ones built from scaling and rotation
    (which still give the normals).  ``ndc_offset``: see ``project_points``.
    """
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    if cov3d_precomp is None:
        cov3d = build_covariance_packed(scaling, rotation, scaling_modifier)
    elif cov3d_precomp.dim() == 3:       # (N, 3, 3) full matrices
        cov3d = strip_symmetric(cov3d_precomp)
    else:                                # already packed (N, 6)
        cov3d = cov3d_precomp
    means2d, depths = project_points(xyz, full_proj, width, height,
                                     ndc_offset)
    cov2d = compute_cov2d(xyz, cov3d, world_view, tanfovx, tanfovy,
                          focal_x, focal_y)

    a, b, c = cov2d.unbind(dim=1)
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    # zero-opacity Gaussians contribute nothing: culling them here keeps
    # them out of the tile pair lists
    op = opacity.reshape(-1)
    visible = (depths > NEAR_CULL) & det_ok & (op > 0.0)
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    op = torch.where(visible, op, torch.zeros_like(op))

    normals = flat_normals(scaling, rotation, xyz, campos)
    return ProjectedGaussians(means2d=means2d, depths=depths, conics=conics,
                              radii=radii, colors=colors, opacities=op,
                              normals=normals)


class _Camera(ctypes.Structure):
    """csrc/project_common.cuh's Camera, field for field."""
    _fields_ = [("world_view", ctypes.c_float * 16),
                ("full_proj", ctypes.c_float * 16),
                ("quad", ctypes.c_float * 36),
                ("campos", ctypes.c_float * 3),
                ("focal_x", ctypes.c_float), ("focal_y", ctypes.c_float),
                ("lim_x", ctypes.c_float), ("lim_y", ctypes.c_float),
                ("width", ctypes.c_float), ("height", ctypes.c_float),
                ("scaling_modifier", ctypes.c_float)]


class _Cotangents(ctypes.Structure):
    """csrc/project_bwd.cu's Cotangents, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("means2d", "depths", "conics", "opacities", "normals")] + [
        (name, ctypes.c_longlong) for name in
        ("means2d_s0", "means2d_s1", "depths_s0", "conics_s0", "conics_s1",
         "opacities_s0", "normals_s0", "normals_s1")]


class _Gradients(ctypes.Structure):
    """csrc/project_bwd.cu's Gradients, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("xyz", "scaling", "rotation", "opacity", "ndc_offset", "cov")]


# the packed covariance's (i, j) pairs, in compute_cov2d's order
_PAIRS_I, _PAIRS_J = [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]
# where the covariance comes from (project_common.cuh CovSource)
_COV_BUILT, _COV_PACKED, _COV_FULL = 0, 1, 2


def _host_f32(a, shape) -> np.ndarray:
    """A camera array (the Camera's numpy array) as float32 numpy."""
    return np.asarray(a, dtype=np.float32).reshape(shape)


def camera_arg(world_view, full_proj, campos, width: int, height: int,
               tanfovx: float, tanfovy: float,
               scaling_modifier: float = 1.0) -> _Camera:
    """Kernel P's camera, every number float32 as the plain version rounds
    it on a float32 tensor.  The matrices are the Camera's numpy arrays.
    ``compute_cov2d``'s quad matrix is formed here in float32 numpy, one
    rounding an operation as the plain version forms it."""
    wv = _host_f32(world_view, (4, 4))
    w = wv[:3, :3].T
    wi, wj = w[_PAIRS_I], w[_PAIRS_J]
    quad = np.stack([
        wi[:, 0] * wj[:, 0],
        wi[:, 0] * wj[:, 1] + wi[:, 1] * wj[:, 0],
        wi[:, 0] * wj[:, 2] + wi[:, 2] * wj[:, 0],
        wi[:, 1] * wj[:, 1],
        wi[:, 1] * wj[:, 2] + wi[:, 2] * wj[:, 1],
        wi[:, 2] * wj[:, 2],
    ])                                   # (6 channels, 6 pairs)
    cam = _Camera()
    cam.world_view[:] = wv.ravel().tolist()
    cam.full_proj[:] = _host_f32(full_proj, (16,)).tolist()
    cam.quad[:] = quad.ravel().tolist()
    cam.campos[:] = _host_f32(campos, (3,)).tolist()
    cam.focal_x = width / (2.0 * tanfovx)
    cam.focal_y = height / (2.0 * tanfovy)
    cam.lim_x = 1.3 * tanfovx
    cam.lim_y = 1.3 * tanfovy
    cam.width, cam.height = float(width), float(height)
    cam.scaling_modifier = scaling_modifier
    return cam


def _check_inputs(name: str, xyz, scaling, rotation, opacity, cov3d_precomp,
                  ndc_offset=None) -> tuple:
    """Refuses kernel P's (or P''s) inputs where its C entry cannot take
    them; returns (n, the covariance's source)."""
    _build.require(name, "xyz", xyz, like=xyz, shape=(None, 3))
    n = xyz.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} Gaussians, the kernel indexes int32")
    src = (_COV_BUILT if cov3d_precomp is None else
           _COV_PACKED if cov3d_precomp.dim() == 2 else _COV_FULL)
    for arg, t, shape in (
            ("scaling", scaling, (n, 3)), ("rotation", rotation, (n, 4)),
            ("opacity", opacity, (n,) if opacity.dim() == 1 else (n, 1)),
            ("cov3d_precomp", cov3d_precomp,
             (n, 6) if src == _COV_PACKED else (n, 3, 3)),
            ("ndc_offset", ndc_offset, (n, 2))):
        if t is not None:
            _build.require(name, arg, t, like=xyz, shape=shape)
    return n, src


@spanned("kernel.project")
def project_gaussians_forward(cam: _Camera, xyz, scaling, rotation, opacity,
                              cov3d_precomp=None, ndc_offset=None) -> tuple:
    """Kernel P without autograd, on CUDA tensors: (means2d, depths,
    conics, radii, opacities, normals) as ``project_plain`` gives them, in
    one launch of csrc/project.cu (none for N = 0).  ``cam``:
    ``camera_arg``."""
    n, src = _check_inputs("project_gaussians", xyz, scaling, rotation,
                           opacity, cov3d_precomp, ndc_offset)
    dev = xyz.device
    means2d = torch.empty((n, 2), device=dev)
    depths = torch.empty((n,), device=dev)
    conics = torch.empty((n, 3), device=dev)
    radii = torch.empty((n,), dtype=torch.int32, device=dev)
    opacities = torch.empty((n,), device=dev)
    normals = torch.empty((n, 3), device=dev)
    _build.launch("project", "project_forward", "PiPPPPPiPPPPPPP",
                  ctypes.byref(cam), n, xyz, scaling, rotation, opacity,
                  cov3d_precomp, src, ndc_offset, means2d, depths, conics,
                  radii, opacities, normals, like=xyz,
                  counter=project_gaussians, launched=n > 0)
    return means2d, depths, conics, radii, opacities, normals


_COTANGENT_SHAPES = (("means2d", 2), ("depths", 1), ("conics", 3),
                     ("opacities", 1), ("normals", 3))


@spanned("kernel.project_bwd")
def project_gaussians_backward(cam: _Camera, xyz, scaling, rotation, opacity,
                               cov3d_precomp, cotangents, needs) -> tuple:
    """Kernel P': the VJP of kernel P for the same camera and inputs, on
    CUDA tensors, in one launch of csrc/project_bwd.cu (none for N = 0).

    cotangents: those of (means2d, depths, conics, opacities, normals),
    float32 tensors of any strides or None (zero).  needs: whether each of
    (xyz, scaling, rotation, opacity, cov3d_precomp, ndc_offset) wants a
    gradient.  Returns their gradients, None where not wanted, and for
    scaling where a given covariance leaves it without one."""
    name = "project_gaussians_backward"
    n, src = _check_inputs(name, xyz, scaling, rotation, opacity,
                           cov3d_precomp)
    g = _Cotangents()
    for (arg, width), t in zip(_COTANGENT_SHAPES, cotangents):
        if t is None:
            continue
        _build.require(name, f"the cotangent of {arg}", t, like=xyz,
                       shape=(n, width) if width > 1 else (n,),
                       contiguous=False)
        setattr(g, arg, t.data_ptr())
        for d, stride in enumerate(t.stride()):
            setattr(g, f"{arg}_s{d}", stride)
    like = (xyz, scaling if src == _COV_BUILT else None, rotation, opacity,
            cov3d_precomp)
    grads = [torch.empty_like(t) if want and t is not None else None
             for want, t in zip(needs[:5], like)]
    grads.append(torch.empty((n, 2), device=xyz.device) if needs[5]
                 else None)
    d = _Gradients(*(t.data_ptr() if t is not None else None for t in
                     (grads[0], grads[1], grads[2], grads[3], grads[5],
                      grads[4])))
    _build.launch("project_bwd", "project_backward", "PiPPPPPiPP",
                  ctypes.byref(cam), n, xyz, scaling, rotation, opacity,
                  cov3d_precomp, src, ctypes.byref(g), ctypes.byref(d),
                  like=xyz, counter=project_gaussians_backward,
                  launched=n > 0)
    return tuple(grads)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cam, xyz, scaling, rotation, opacity, cov3d_precomp,
                ndc_offset):
        out = project_gaussians_forward(cam, xyz, scaling, rotation, opacity,
                                        cov3d_precomp, ndc_offset)
        ctx.save_for_backward(xyz, scaling, rotation, opacity, cov3d_precomp)
        ctx.cam = cam
        ctx.mark_non_differentiable(out[3])
        # absent cotangents stay None: P' reads them as zeros, no fill
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, _g_radii, g_opacities,
                 g_normals):
        grads = project_gaussians_backward(
            ctx.cam, *ctx.saved_tensors,
            (g_means2d, g_depths, g_conics, g_opacities, g_normals),
            ctx.needs_input_grad[1:])
        return (None, *grads)


def project_gaussians(xyz, scaling, rotation, opacity, colors,
                      world_view, full_proj, campos,
                      width: int, height: int, tanfovx: float, tanfovy: float,
                      scaling_modifier: float = 1.0,
                      cov3d_precomp=None, ndc_offset=None) -> ProjectedGaussians:
    """Cull + project + conic/radius + normals (``project_plain``'s
    outputs), differentiable in xyz, scaling, rotation, opacity,
    cov3d_precomp and ndc_offset.

    world_view, full_proj, campos: the Camera's numpy arrays.  CPU
    tensors take ``project_plain``; CUDA tensors one
    launch of kernel P, and one of P' in the backward where an input needs
    a gradient.  ``colors`` passes through (None where the caller fills
    them in later)."""
    if xyz.device.type == "cpu":
        def on_cpu(a):
            return torch.as_tensor(a, dtype=torch.float32)
        return project_plain(xyz, scaling, rotation, opacity, colors,
                             on_cpu(world_view), on_cpu(full_proj),
                             on_cpu(campos), width, height, tanfovx, tanfovy,
                             scaling_modifier=scaling_modifier,
                             cov3d_precomp=cov3d_precomp,
                             ndc_offset=ndc_offset)
    cam = camera_arg(world_view, full_proj, campos, width, height, tanfovx,
                     tanfovy, scaling_modifier)
    means2d, depths, conics, radii, opacities, normals = _Project.apply(
        cam, xyz, scaling, rotation, opacity, cov3d_precomp, ndc_offset)
    return ProjectedGaussians(means2d=means2d, depths=depths, conics=conics,
                              radii=radii, colors=colors, opacities=opacities,
                              normals=normals)


project_gaussians.launches = 0
project_gaussians_backward.launches = 0


def det_condition(conics: torch.Tensor) -> torch.Tensor:
    """Each Gaussian's condition number of det = a c - b^2 of its screen
    covariance (read back from its packed conic), in float64: (|a c| +
    b^2) / |det|; inf where the conic is zero.  The checks of kernel P'
    hold its gradients tightly where this is small."""
    c0, c1, c2 = conics.double().unbind(-1)
    inv = c0 * c2 - c1 * c1      # the conic's det, 1 / det
    a, b, c = c2 / inv, -c1 / inv, c0 / inv
    kappa = ((a * c).abs() + b * b) / (a * c - b * b).abs()
    return kappa.nan_to_num(nan=float("inf"))


def conic_offsets(got: torch.Tensor, want: torch.Tensor,
                  exact: torch.Tensor) -> tuple:
    """How far kernel P's conics ``got`` lie from the plain chain's
    ``want``, with ``exact`` the plain chain's in float64: (each
    Gaussian's |got - want| / |exact|, the plain chain's own largest such
    distance from ``exact``, the count of Gaussians beyond twice that
    plus 1e-6).  A conic inverts a 2x2 covariance whose determinant
    cancels for a disc seen edge on, so two float32 orders of the same
    chain part by as much as either parts from float64.  A Gaussian whose
    float32 det is 0 (conic 0) has no float64 twin, where its det is not
    0: it counts |got - want| alone."""
    live = (want != 0).any(1)
    norm = torch.where(live, exact.norm(dim=1), 1.0).clamp(min=1e-30)
    rel = (got.double() - want.double()).norm(dim=1) / norm
    own = ((want.double() - exact).norm(dim=1) / norm)[live]
    own = own.max().item() if own.numel() else 0.0
    return rel, own, int((rel > 2 * own + 1e-6).sum())


def sh_colors(features: torch.Tensor, xyz: torch.Tensor, campos: torch.Tensor,
              active_sh_degree: int) -> torch.Tensor:
    """Per-Gaussian view-dependent color from SH coefficients (N, K, 3)
    (direction = campos -> center), clamped at 0 after the +0.5 offset, as
    the CUDA preprocess does."""
    dirs = xyz - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(active_sh_degree, features.transpose(-1, -2), dirs) + 0.5
    return torch.clamp(rgb, min=0.0)


def band_rows(proj: ProjectedGaussians, row_offset: int,
              band_height: Optional[int]):
    """(proj, height) of the band of rows [row_offset, row_offset +
    band_height): the projected means moved up by row_offset, so binning
    and the kernels see the band as a short image of band-local tiles
    (texgs render.py:67-77)."""
    if band_height is None:
        raise ValueError("row_offset needs band_height")
    shift = torch.tensor([0.0, float(row_offset)], device=proj.means2d.device)
    return proj._replace(means2d=proj.means2d - shift), int(band_height)
