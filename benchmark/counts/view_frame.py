"""One viewer frame's FLOPs and bytes (``visual_step``, forward only),
from shapes, with the forward share of each of
texgs_torch/tools/roofline.py's formulas: projection, SH, binning, the
blend and the M-lists, the texture term, and the UV MLP with its three
Jacobian tangents.  No loss, backward or Adam."""

PIX = 256


def count(c: dict) -> tuple[float, float]:
    n, p = c["n"], c["n_pairs"]
    px = c["width"] * c["height"]
    nb = (c["sh_degree"] + 1) ** 2
    w = c["mlp_width"]
    comps = {
        "sh_eval": (n * (4 * nb + 2 * nb * 3), n * (nb * 3 + 3 + 3) * 4 * 2),
        "project": (n * 250, n * 60 * 4 * 2),
        "binning": (p * 10, p * 8 * 4 * 2 * 2),
        "blend": (p * PIX * 40, p * 16 * 4),
        "mlist": (p * PIX * 10, px * c["m"] * 4 * 4),
        "texture": (px * c["m"] * 4 * 12, px * c["m"] * 4 * 12),
        "uv_mlp_jac": (n * 2 * 4 * w * w * (1 + 3), n * (3 + 9 + w) * 4),
    }
    return (sum(b for _, b in comps.values()),
            sum(f for f, _ in comps.values()))
