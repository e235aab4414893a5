"""Analytic FLOP and memory-byte model of one training step, and its share
of the H100's peaks (port of texgs/tools/roofline.py).

The counts come from shapes, not from the code that runs: each
component's formula is written out below, and ``stage1_counts`` and
``stage3_counts`` keep texgs's formulas and defaults, so both packages
count the same work.  A component's ``unit`` names the kind of work:
``matmul`` (the UV MLP and Jacobian pushes, the inverse nets),
``elementwise`` (projection, the blend, the losses) or ``memory`` (sorts,
M-list and texture traffic, Adam).

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s in float32 outside the
tensor cores and 3.35 TB/s of HBM3, at the full 700 W power limit.  The
port computes in float32 with TF32 off (``texgs_torch/__init__.py``), so
matmul and elementwise work share the one float32 peak.  ``mfu_pct`` is
the step's FLOPs over the measured step time and that peak: the share of
the whole step, whatever implements it.
"""

from __future__ import annotations

H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3

PIX = 256                    # pixels per tile (16x16)


def stage1_counts(n: int, n_pairs: int, width: int, height: int,
                  sh_deg: int = 3):
    """Per-step FLOPs and bytes of the stage-1 train step (forward,
    backward and Adam; x3 ~= forward + a backward at twice its cost)."""
    px = width * height
    n_basis = (sh_deg + 1) ** 2
    comps = {}

    # SH eval: basis polynomial (~4 FLOPs a term) + (n_basis x 3) dot, x3
    comps["sh_eval"] = dict(
        flops=3 * n * (4 * n_basis + 2 * n_basis * 3),
        bytes=n * (n_basis * 3 + 3 + 3) * 4 * 2,   # read shs + xyz, write rgb
        unit="elementwise")
    # projection + EWA quad + 2x2 inverse + radii (~250 FLOP forward)
    comps["project"] = dict(flops=3 * n * 250, bytes=n * 60 * 4 * 2,
                            unit="elementwise")
    # binning: a sort of P keys, bandwidth, ~4 passes of read + write
    comps["binning"] = dict(flops=n_pairs * 10,
                            bytes=n_pairs * 8 * 4 * 2 * 2, unit="memory")
    # blend: per (pair, pixel) conic quad 10 + exp ~8 + T update 4 +
    # 9-channel FMA 18 = ~40 FLOP forward, x3 with the backward
    comps["blend"] = dict(flops=3 * n_pairs * PIX * 40,
                          bytes=n_pairs * 16 * 4 * 3,  # attrs read twice, written
                          unit="elementwise")
    # image losses (L1 + separable 11-tap SSIM): ~(2 + 4*11) FLOP/px/ch, x3
    comps["loss"] = dict(flops=3 * px * 3 * 46, bytes=px * 3 * 4 * 6,
                         unit="elementwise")
    # Adam on 59 f32 a Gaussian: ~12 FLOP a parameter; params, grad, mu,
    # nu read and written
    comps["adam"] = dict(flops=n * 59 * 12, bytes=n * 59 * 4 * 7,
                         unit="memory")
    return comps


def stage3_counts(n: int, n_pairs: int, width: int, height: int,
                  tex_res: int = 1024, m: int = 32, sh_deg: int = 3,
                  mlp_width: int = 128, n_inv: int = 8192):
    """Per-step FLOPs and bytes of the stage-3 train step (fused path, the
    no-SH image from the same pass, the hand-rolled UV Jacobian, SSIM
    twice, the inverse consistency loss, three Adams)."""
    px = width * height
    comps = stage1_counts(n, n_pairs, width, height, sh_deg)

    # UV MLP (3->128, 128->128 pre; 128->128 x2, 128->3): ~4 dense layers
    # of 128x128 = 2*4*128*128 FLOP a point; the Jacobian is 3 tangent
    # pushes through the same weights (~3x), the backward ~2x
    mlp_flops = 2 * 4 * mlp_width * mlp_width
    comps["uv_mlp_jac"] = dict(flops=n * mlp_flops * (1 + 3 + 2),
                               bytes=n * (3 + 9 + mlp_width) * 4 * 3,
                               unit="matmul")
    # M-list production: the blend is counted above; ~10 FLOP of slot
    # bookkeeping per (pair, pixel) + the M-list write
    comps["mlist"] = dict(flops=3 * n_pairs * PIX * 10,
                          bytes=(px * m * 4) * 4 * 2, unit="memory")
    # texture term: 4 bilinear taps per (pixel, slot), 12 B gathered and
    # ~12 FLOP each forward; the backward scatters the same taps
    comps["texture"] = dict(flops=3 * px * m * (4 * 12),
                            bytes=px * m * 4 * 12 * 2, unit="memory")
    # the second SSIM (no-SH image) + inverse consistency (n_inv points
    # through the inverse hash-grid MLP and the UV net, ~6 dense layers)
    comps["loss"]["flops"] *= 2
    comps["loss"]["bytes"] *= 2
    comps["inverse"] = dict(
        flops=3 * n_inv * (6 * 2 * mlp_width * mlp_width),
        bytes=n_inv * mlp_width * 4 * 6, unit="matmul")
    # texture Adam: 6*R^2*3 params x (grad w + p r/w + mu, nu r/w) = 7 passes
    tex_params = 6 * tex_res * tex_res * 3
    comps["adam_tex"] = dict(flops=tex_params * 12, bytes=tex_params * 4 * 7,
                             unit="memory")
    return comps


def summarize(comps: dict, dt: float) -> dict:
    """Totals, and the shares of the H100's peaks at the measured step
    time ``dt`` (seconds).  ``bound`` names the larger of the two ideal
    times: all FLOPs at the float32 peak, or all bytes at the HBM rate."""
    f_tot = sum(c["flops"] for c in comps.values())
    b_tot = sum(c["bytes"] for c in comps.values())
    t_flops, t_hbm = f_tot / H100_F32_FLOPS, b_tot / H100_BYTES_PER_S
    return {
        "gflops_per_step": round(f_tot / 1e9, 2),
        "hbm_gb_per_step": round(b_tot / 1e9, 3),
        "t_flops_ms": round(t_flops * 1e3, 3),
        "t_hbm_ms": round(t_hbm * 1e3, 3),
        "mfu_pct": round(f_tot / dt / H100_F32_FLOPS * 100, 2),
        "hbm_util_pct": round(b_tot / dt / H100_BYTES_PER_S * 100, 1),
        "step_ms": round(dt * 1e3, 1),
        "bound": "flops" if t_flops >= t_hbm else "memory",
    }


def table(comps: dict) -> str:
    """Markdown component table."""
    rows = ["| component | GFLOP | HBM MB | work | FLOP/B |",
            "|---|---|---|---|---|"]
    for k, c in comps.items():
        ai = c["flops"] / max(c["bytes"], 1)
        rows.append(f"| {k} | {c['flops'] / 1e9:.2f} | "
                    f"{c['bytes'] / 1e6:.1f} | {c['unit']} | {ai:.0f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import json
    import sys

    n, pairs = 100_000, 500_000
    s1 = stage1_counts(n, pairs, 800, 600)
    s3 = stage3_counts(n, pairs, 800, 600)
    dt1 = float(sys.argv[1]) if len(sys.argv) > 1 else 0.040
    dt3 = float(sys.argv[2]) if len(sys.argv) > 2 else 0.341
    print("stage-1 @", dt1, "s:", json.dumps(summarize(s1, dt1)))
    print(table(s1))
    print("stage-3 @", dt3, "s:", json.dumps(summarize(s3, dt3)))
    print(table(s3))
