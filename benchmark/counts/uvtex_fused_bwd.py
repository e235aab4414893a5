"""Kernel A' (``fused_pairs_backward``): what it must move and do, from the
call's quantities (copied from chip_smoke.py's training-step bound).

Bytes: the table, uv rows and pair list, the blend and T_final with their
cotangents, every slot's w (4 B; the slot's uv is not read), the cotangent
of the live slots only (16 B), and the two gradients it writes (the
table's and the uv rows' shapes).  Operations: 40 + 3F per evaluated
(pixel, pair) and 90 per live slot."""

OPS_EVAL, OPS_SLOT = 40, 90
UV_COLS = 24


def count(c: dict) -> tuple[float, float]:
    px = c["n_tiles"] * 256
    table = c["n"] * (16 + c["n_f"] - 7) * 4
    uv = c["n"] * UV_COLS * 4
    n_bytes = (2 * (table + uv) + c["n_pairs"] * 4 + c["n_tiles"] * 8
               + 2 * (px * c["n_f"] * 4 + px * 4)
               + 4 * px * c["m"] + 16 * c["live"])
    return n_bytes, c["n_eval"] * (OPS_EVAL + 3 * c["n_f"]) + c["live"] * OPS_SLOT
