"""One stage-3 training step's FLOPs and bytes (fused path, SSIM twice,
the inverse term over ``n_inv`` points, three Adams), from shapes.  A
frozen copy of texgs_torch/tools/roofline.py's ``stage1_counts`` and
``stage3_counts`` (texgs's formulas): ``count`` sums the components."""

PIX = 256


def stage1_counts(n, n_pairs, width, height, sh_deg=3):
    px = width * height
    nb = (sh_deg + 1) ** 2
    return {
        "sh_eval": dict(flops=3 * n * (4 * nb + 2 * nb * 3),
                        bytes=n * (nb * 3 + 3 + 3) * 4 * 2),
        "project": dict(flops=3 * n * 250, bytes=n * 60 * 4 * 2),
        "binning": dict(flops=n_pairs * 10, bytes=n_pairs * 8 * 4 * 2 * 2),
        "blend": dict(flops=3 * n_pairs * PIX * 40, bytes=n_pairs * 16 * 4 * 3),
        "loss": dict(flops=3 * px * 3 * 46, bytes=px * 3 * 4 * 6),
        "adam": dict(flops=n * 59 * 12, bytes=n * 59 * 4 * 7),
    }


def stage3_counts(n, n_pairs, width, height, tex_res=1024, m=32, sh_deg=3,
                  mlp_width=128, n_inv=8192):
    px = width * height
    comps = stage1_counts(n, n_pairs, width, height, sh_deg)
    mlp_flops = 2 * 4 * mlp_width * mlp_width
    comps["uv_mlp_jac"] = dict(flops=n * mlp_flops * (1 + 3 + 2),
                               bytes=n * (3 + 9 + mlp_width) * 4 * 3)
    comps["mlist"] = dict(flops=3 * n_pairs * PIX * 10,
                          bytes=(px * m * 4) * 4 * 2)
    comps["texture"] = dict(flops=3 * px * m * (4 * 12),
                            bytes=px * m * 4 * 12 * 2)
    comps["loss"]["flops"] *= 2
    comps["loss"]["bytes"] *= 2
    comps["inverse"] = dict(flops=3 * n_inv * (6 * 2 * mlp_width * mlp_width),
                            bytes=n_inv * mlp_width * 4 * 6)
    tex_params = 6 * tex_res * tex_res * 3
    comps["adam_tex"] = dict(flops=tex_params * 12, bytes=tex_params * 4 * 7)
    return comps


def count(c: dict) -> tuple[float, float]:
    comps = stage3_counts(c["n"], c["n_pairs"], c["width"], c["height"],
                          c["tex_res"], c["m"], c["sh_degree"], c["mlp_width"],
                          c["n_inv"])
    return (sum(v["bytes"] for v in comps.values()),
            sum(v["flops"] for v in comps.values()))
